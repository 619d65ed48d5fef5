"""The port's replay infeed (sheeprl_tpu_torch/data/infeed.py) against the
JAX package's ``ReplayInfeed``, on the CPU: both buffers built after the same
``np.random.seed`` (their sampling streams derive from it) take the same adds,
and the same sequence of ``take_or_sample`` and ``stage`` calls, a miss
included, hands out equal batches, with ``prefetch`` on and off. The CNN
keys keep their uint8, the others are float32, as the JAX infeed's."""

import numpy as np
import pytest
import torch

from sheeprl_tpu.data.buffers import EnvIndependentReplayBuffer as JaxBuffer
from sheeprl_tpu.data.buffers import SequentialReplayBuffer as JaxSequential
from sheeprl_tpu.data.infeed import ReplayInfeed as JaxInfeed
from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer
from sheeprl_tpu_torch.data.infeed import AsyncInfeed, ReplayInfeed


def adds(rng, t, n):
    return {
        "rgb": rng.integers(0, 256, (t, n, 4, 4, 3)).astype(np.uint8),
        "actions": rng.normal(size=(t, n, 2)).astype(np.float32),
        "rewards": rng.normal(size=(t, n, 1)).astype(np.float32),
        "is_first": (rng.random((t, n, 1)) < 0.2).astype(np.float32),
    }


@pytest.mark.parametrize("prefetch", [False, True], ids=["off", "prefetch"])
def test_batches_equal_the_jax_infeeds(prefetch):
    np.random.seed(11)
    jrb = JaxBuffer(32, n_envs=2, obs_keys=("rgb",), buffer_cls=JaxSequential)
    np.random.seed(11)
    prb = EnvIndependentReplayBuffer(32, n_envs=2, obs_keys=("rgb",))
    jinfeed = JaxInfeed(jrb, 3, 4, ["rgb"], enabled=prefetch)
    pinfeed = ReplayInfeed(prb, 3, 4, ["rgb"], torch.device("cpu"), enabled=prefetch)
    rng = np.random.default_rng(0)
    try:
        # (rows added before the call, gradient steps of the call): the
        # third call asks for more batches than were staged, a miss.
        for new_rows, n in ((9, 2), (1, 2), (1, 3), (2, 1), (1, 1)):
            data = adds(rng, new_rows, 2)
            jrb.add(data)
            prb.add(data)
            want, got = jinfeed.take_or_sample(n), pinfeed.take_or_sample(n)
            assert len(got) == len(want) == n
            for w, g in zip(want, got):
                assert set(g) == set(w)
                for k in w:
                    assert g[k].dtype == (torch.uint8 if k == "rgb" else torch.float32), k
                    np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]), err_msg=k)
            jinfeed.stage(n)
            pinfeed.stage(n)
        expected = (3, 2) if prefetch else (0, 0)  # the first call and the 3-step call miss
        assert (pinfeed.hits, pinfeed.misses) == expected
        assert (jinfeed._infeed.hits, jinfeed._infeed.misses) == expected if prefetch else jinfeed._infeed is None
    finally:
        jinfeed.close()
        pinfeed.close()


def test_async_infeed_serves_a_larger_stage_and_drops_an_untaken_one():
    infeed = AsyncInfeed(lambda batches: [b * 10 for b in batches])
    try:
        assert infeed.take(1) is None
        infeed.stage([1, 2, 3])
        assert infeed.take(2) == [10, 20]
        infeed.stage([4])
        infeed.stage([5, 6])  # the first stage was never taken
        assert infeed.take(2) == [50, 60]
        infeed.stage([7])
        assert infeed.take(2) is None
        assert (infeed.hits, infeed.misses) == (2, 2)
    finally:
        infeed.close()
