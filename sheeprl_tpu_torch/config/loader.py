"""Config composition from the port's YAML tree (counterpart of
sheeprl_tpu/config/loader.py, the Hydra subset the JAX package implements).

- a root ``config.yaml`` with a ``defaults`` list;
- config groups (``algo/``, ``env/``, ``exp/``, ...) chosen with ``- group:
  option`` entries or ``group=option`` overrides;
- ``_self_`` ordering and same-group includes (``- dreamer_v3``);
- ``override /group: option`` directives;
- packages: ``# @package _global_`` headers and ``@pkg`` targets
  (``/optim@world_model.optimizer: adam``);
- ``key=value`` overrides of existing keys and ``+key=value`` additions,
  the values read by the YAML reader (:func:`parse_value`);
- a mandatory ``???`` group raises;
- ``${a.b}`` interpolation with the ``${now:<strftime format>}``,
  ``${oc.env:VAR,default}`` and ``${hydra:runtime.choices.<group>}``
  resolvers (the last is Hydra's record of the option a group resolved to:
  the port's ``env_group`` key reads ``env``'s);
- the ``SHEEPRL_SEARCH_PATH`` search path (``:``-separated directories,
  ``file://`` prefixes allowed), searched before the port's
  ``sheeprl_tpu_torch/configs``.

Files are read with :mod:`sheeprl_tpu_torch.config.reader`, which gives the
values PyYAML gives the JAX package. The result is a
:class:`sheeprl_tpu_torch.utils.utils.dotdict`.
"""

from __future__ import annotations

import copy
import datetime
import os
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from sheeprl_tpu_torch.config import reader
from sheeprl_tpu_torch.utils.utils import dotdict, get_by_path, set_by_path

MISSING = "???"

_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")
_CHOICES = "hydra:runtime.choices."


class ConfigError(ValueError):
    pass


class MandatoryValueError(ConfigError):
    pass


def default_config_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")


def search_paths() -> List[str]:
    """Config roots, highest priority first: ``SHEEPRL_SEARCH_PATH``'s
    directories, then the port's tree."""
    paths = []
    for entry in os.environ.get("SHEEPRL_SEARCH_PATH", "").split(":"):
        entry = entry.strip()
        if not entry:
            continue
        if entry.startswith("file://"):
            entry = entry[len("file://") :]
        if os.path.isdir(entry):
            paths.append(entry)
    paths.append(default_config_dir())
    return paths


@dataclass
class _Entry:
    """One node of the expanded defaults tree."""

    group: str  # group path relative to the config root, "" for the root
    option: str
    package: str  # absolute package ("" is global)
    content: Dict[str, Any] = field(default_factory=dict)


def _strip_ext(name: str) -> str:
    return name[:-5] if isinstance(name, str) and name.endswith(".yaml") else name


def _join_pkg(parent: str, child: str) -> str:
    if child.startswith("_global_"):
        return child[len("_global_") :].lstrip(".")
    if not parent:
        return child
    if not child:
        return parent
    return f"{parent}.{child}"


class Composer:
    def __init__(self, roots: Optional[Sequence[str]] = None):
        self.roots = list(roots) if roots else search_paths()
        # Files do not change within one composition: each is read once.
        self._file_cache: Dict[str, Tuple[Dict[str, Any], List[Any], Optional[str]]] = {}

    # ------------------------------------------------------------------ files
    def _find_file(self, group: str, option: str) -> Optional[str]:
        option = _strip_ext(option)
        for root in self.roots:
            path = os.path.join(root, group, option + ".yaml") if group else os.path.join(root, option + ".yaml")
            if os.path.isfile(path):
                return path
        return None

    def is_group(self, name: str) -> bool:
        return any(os.path.isdir(os.path.join(root, name)) for root in self.roots)

    def _load_file(self, group: str, option: str) -> Tuple[Dict[str, Any], List[Any], Optional[str]]:
        """(content without its defaults, the defaults list, the package header)."""
        path = self._find_file(group, option)
        if path is None:
            where = f"{group}={option}" if group else option
            raise ConfigError(f"{where} is not in the port's config tree (config file not found; roots={self.roots})")
        cached = self._file_cache.get(path)
        if cached is not None:
            return cached
        content, pkg_header = reader.load_file(path)
        content = content or {}
        if not isinstance(content, dict):
            raise ConfigError(f"Config file {path} must contain a mapping at top level")
        defaults = content.pop("defaults", [])
        self._file_cache[path] = (content, defaults, pkg_header)
        return content, defaults, pkg_header

    # -------------------------------------------------------------- expansion
    @staticmethod
    def _parse_entry(raw: Any, group: str, own_pkg: str):
        """One defaults entry as (is_override, full_group, choice_key,
        child_pkg, default_option). The choices walk and the expansion walk
        both parse entries here, so an ``override`` finds its choice key."""
        if not isinstance(raw, dict) or len(raw) != 1:
            raise ConfigError(f"Malformed defaults entry {raw!r} in group '{group}'")
        k, v = next(iter(raw.items()))
        k = k.strip()
        is_override = k.startswith("override ")
        if is_override:
            k = k[len("override ") :].strip()
        at_pkg = None
        if "@" in k:
            k, at_pkg = k.split("@", 1)
        absolute = k.startswith("/")
        g = k.lstrip("/")
        full_group = g if (absolute or not group) else f"{group}/{g}"
        if at_pkg is not None:
            child_pkg = _join_pkg(own_pkg, at_pkg)
            choice_key = f"{full_group}@{child_pkg}"
        else:
            child_pkg = _join_pkg(own_pkg, os.path.basename(full_group))
            choice_key = full_group
        return is_override, full_group, choice_key, child_pkg, _strip_ext(v) if isinstance(v, str) else v

    def _own_pkg(self, pkg_header: Optional[str], parent_pkg: str) -> str:
        if pkg_header is None:
            return parent_pkg
        return "" if pkg_header == "_global_" else _join_pkg("", pkg_header)

    def _expand(
        self, group: str, option: str, parent_pkg: str, choices: Dict[str, str], out: List[_Entry], selected: Dict[str, str],
        seen: Optional[set] = None,
    ) -> None:  # fmt: skip
        """Depth-first expansion of a config file into its merge entries, in
        order; ``selected`` records the option each group entry resolved to."""
        seen = seen or set()
        key = (group, option)
        if key in seen:
            raise ConfigError(f"Cyclic defaults detected at {key}")
        seen = seen | {key}

        content, defaults, pkg_header = self._load_file(group, option)
        own_pkg = self._own_pkg(pkg_header, parent_pkg)
        entries: List[Any] = list(defaults)
        if not any(e == "_self_" for e in entries):
            entries.insert(0, "_self_")

        for raw in entries:
            if raw == "_self_":
                out.append(_Entry(group, option, own_pkg, content))
                continue
            if isinstance(raw, str):
                # A same-group include, e.g. "- dreamer_v3" inside algo/.
                self._expand(group, _strip_ext(raw), own_pkg, choices, out, selected, seen)
                continue
            is_override, full_group, choice_key, child_pkg, default_opt = self._parse_entry(raw, group, own_pkg)
            if is_override:
                continue  # recorded by the choices walk
            sel = choices.get(choice_key, default_opt)
            if sel is None:
                continue
            sel = _strip_ext(sel)
            if sel == MISSING:
                raise MandatoryValueError(f"You must specify '{full_group}', e.g. with the CLI override '{full_group}=<option>'")
            selected[choice_key] = sel
            self._expand(full_group, sel, child_pkg, choices, out, selected, seen)

    def _collect_choices(
        self, group: str, option: str, parent_pkg: str, choices: Dict[str, str], cli_choices: Dict[str, str], seen: Optional[set] = None
    ) -> None:
        """Record the ``override`` directives of the defaults tree (later in
        the walk wins), keyed ``group`` or ``group@absolute.package``; the
        command line's choices always win."""
        seen = seen or set()
        key = (group, option)
        if key in seen:
            return
        seen = seen | {key}
        try:
            _, defaults, pkg_header = self._load_file(group, option)
        except ConfigError:
            return
        own_pkg = self._own_pkg(pkg_header, parent_pkg)
        for raw in defaults:
            if raw == "_self_":
                continue
            if isinstance(raw, str):
                self._collect_choices(group, _strip_ext(raw), own_pkg, choices, cli_choices, seen)
                continue
            try:
                is_override, full_group, choice_key, child_pkg, default_opt = self._parse_entry(raw, group, own_pkg)
            except ConfigError:
                continue
            if is_override:
                if choice_key not in cli_choices:
                    choices[choice_key] = default_opt
                continue
            sel = cli_choices.get(choice_key, choices.get(choice_key, default_opt))
            if sel and sel != MISSING:
                self._collect_choices(full_group, sel, child_pkg, choices, cli_choices, seen)

    # ---------------------------------------------------------------- compose
    def compose(self, config_name: str = "config", overrides: Sequence[str] = ()) -> dotdict:
        cli_choices, dotted = self._parse_overrides(overrides)

        # Overrides in newly chosen files may change choices that expose
        # further overrides: walk to a fixed point.
        choices: Dict[str, str] = {}
        for _ in range(8):
            before = dict(choices)
            self._collect_choices("", config_name, "", choices, cli_choices)
            if choices == before:
                break
        choices.update(cli_choices)

        out: List[_Entry] = []
        selected: Dict[str, str] = {}
        self._expand("", config_name, "", choices, out, selected)

        result: Dict[str, Any] = {}
        for entry in out:
            node = copy.deepcopy(entry.content)
            if entry.package:
                wrapped: Dict[str, Any] = {}
                set_by_path(wrapped, entry.package, node)
                node = wrapped
            _deep_merge(result, node)

        missing = object()
        # In command-line order, so '+a.b={}' can add a key that a later
        # 'a.b.c=1' sets.
        for path, value, is_add in dotted:
            if not is_add and get_by_path(result, path, missing) is missing:
                raise ConfigError(f"Could not override '{path}': no such key in the composed config. Use '+{path}={value}' to add a new key.")
            set_by_path(result, path, value)

        return dotdict(_resolve_interpolations(result, selected))

    def _parse_overrides(self, overrides: Sequence[str]):
        cli_choices: Dict[str, str] = {}
        dotted: List[Tuple[str, Any, bool]] = []  # (path, value, is_add), in command-line order
        for ov in overrides:
            if "=" not in ov:
                raise ConfigError(f"Override '{ov}' must be of the form key=value")
            k, v = ov.split("=", 1)
            k = k.strip()
            if k.startswith("+"):
                dotted.append((k[1:], parse_value(v), True))
                continue
            group_key = k.split("@", 1)[0]
            full_key = k.lstrip("/")  # keeps an @pkg suffix for scoped choices
            if "." not in group_key and (self.is_group(group_key) or self._find_file(group_key, _strip_ext(v)) is not None):
                cli_choices[full_key] = _strip_ext(v)
            elif "/" in group_key and self.is_group(group_key.lstrip("/").rsplit("/", 1)[0]):
                cli_choices[full_key] = _strip_ext(v)
            else:
                dotted.append((k, parse_value(v), False))
        return cli_choices, dotted


def parse_value(text: str) -> Any:
    """A command-line value as the YAML reader reads it (``8`` an int,
    ``1e-3`` a float, ``[rgb]`` a list, ``True`` a bool); text that is not
    YAML stays text. YAML outside the reader's subset raises."""
    try:
        return reader.load(text, "<command line>")
    except reader.UnsupportedYaml:
        raise
    except reader.YamlSyntaxError:
        return text


def _deep_merge(dst: Dict[str, Any], src: Dict[str, Any]) -> Dict[str, Any]:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_merge(dst[k], v)
        else:
            dst[k] = v
    return dst


def _resolve_interpolations(root: Dict[str, Any], choices: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
    """Resolve ``${a.b.c}`` references and the resolvers' calls. A value that
    is one reference takes the referenced value, type and all; references
    inside a longer string are replaced by their text. ``${now:...}`` is the
    time of this call, the same everywhere in one config."""
    now = datetime.datetime.now()
    choices = choices or {}
    resolving: set = set()

    def resolve_value(value: Any) -> Any:
        if isinstance(value, str):
            return resolve_str(value)
        if isinstance(value, dict):
            return {k: resolve_value(v) for k, v in value.items()}
        if isinstance(value, list):
            return [resolve_value(v) for v in value]
        return value

    def resolve_str(text: str) -> Any:
        m = _INTERP_RE.fullmatch(text)
        if m:
            return resolve_expr(m.group(1))
        prev = None
        while prev != text and _INTERP_RE.search(text):
            prev = text
            text = _INTERP_RE.sub(lambda match: str(resolve_expr(match.group(1))), text)
        return text

    def resolve_expr(expr: str) -> Any:
        expr = expr.strip()
        if expr.startswith("now:"):
            return now.strftime(expr[len("now:") :])
        if expr.startswith("oc.env:"):
            parts = expr[len("oc.env:") :].split(",", 1)
            return os.environ.get(parts[0], parts[1] if len(parts) > 1 else None)
        if expr.startswith(_CHOICES):
            group = expr[len(_CHOICES) :]
            if group not in choices:
                raise ConfigError(f"${{{expr}}}: no option was chosen for group '{group}'")
            return choices[group]
        if expr in resolving:
            raise ConfigError(f"Interpolation cycle detected at ${{{expr}}}")
        resolving.add(expr)
        try:
            target = get_by_path(root, expr, default=ConfigError)
            if target is ConfigError:
                raise ConfigError(f"Interpolation key not found: ${{{expr}}}")
            return resolve_value(copy.deepcopy(target))
        finally:
            resolving.discard(expr)

    return resolve_value(root)


def compose(overrides: Sequence[str] = (), config_name: str = "config", roots: Optional[Sequence[str]] = None) -> dotdict:
    """The config of ``overrides`` (``exp=<name> env=<name> [key=value ...]``),
    composed from ``config_name`` in the search path's roots."""
    return Composer(roots).compose(config_name, overrides)
