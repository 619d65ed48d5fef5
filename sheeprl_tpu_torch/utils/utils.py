"""Host-side helpers (the part of sheeprl_tpu/utils/utils.py the port needs)."""

from __future__ import annotations


class dotdict(dict):
    """A dictionary with dot access, wrapping nested dicts recursively (the
    config object the adapters read: ``cfg.algo.world_model.discrete_size``)."""

    __getattr__ = dict.get
    __setattr__ = dict.__setitem__
    __delattr__ = dict.__delitem__

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for k, v in self.items():
            if isinstance(v, dict) and not isinstance(v, dotdict):
                self[k] = dotdict(v)
