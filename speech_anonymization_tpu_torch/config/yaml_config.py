"""Registry-based YAML object-graph config loader.

Counterpart of ``speech_anonymization_tpu/config/yaml_config.py`` (the
reference's HyperPyYAML layer), on the port's own YAML reader
(:mod:`.yaml_subset`) instead of PyYAML:

  * ``!new:<path> {kwargs}``  — instantiate via the registry at load time
  * ``!name:<path> {kwargs}`` — partial/factory (``functools.partial``)
  * ``!ref <key>``            — graph reference to another config node;
    strings containing ``<key>`` substrings interpolate their string value
    (``!ref <output_folder>/save``)
  * ``!apply:<path> [args]``  — call at load time

plus CLI override parsing (``--key value`` pairs and/or an overrides YAML
string), mirroring ``sb.parse_arguments``. Every override value from the CLI
goes through the same YAML 1.1 scalar rules as the file.

One addition: the objects the config builds are built on the run's device.
``load_config(..., device=)`` passes ``device`` to every tagged callable whose
signature takes a ``device`` argument, unless the config sets it (so a
``!new:Fbank`` lands on the CPU under ``--device cpu``).
"""

from __future__ import annotations

import functools
import inspect
import re
from typing import Any

from .yaml_subset import YAMLError, load as load_yaml


class _Tagged:
    def __init__(self, path: str, payload: Any):
        self.path = path
        self.payload = payload


class _New(_Tagged):
    pass


class _Name(_Tagged):
    pass


class _Apply(_Tagged):
    pass


class _Ref:
    def __init__(self, expr: str):
        self.expr = expr


_MULTI = (("!new:", _New), ("!name:", _Name), ("!apply:", _Apply))


def _construct(tag: str, kind: str, value: Any) -> Any:
    """The JAX package's tag constructors: a tagged scalar's payload is its
    string, None when empty; ``!ref`` takes a scalar only."""
    for prefix, cls in _MULTI:
        if tag.startswith(prefix):
            payload = (None if value in ("", None) else value) if kind == "scalar" else value
            return cls(tag[len(prefix):], payload)
    if tag == "!ref":
        if kind != "scalar":
            raise YAMLError(f"!ref takes a scalar, not a {kind}")
        return _Ref(value)
    raise YAMLError(f"could not determine a constructor for the tag {tag!r}")


def load_raw(text: str) -> Any:
    """A config's YAML text -> its unresolved tree (tags as ``_New``/``_Name``/
    ``_Apply``/``_Ref`` nodes)."""
    return load_yaml(text, _construct)


_REF_RE = re.compile(r"<([^<>]+)>")


def _takes_device(fn) -> bool:
    try:
        return "device" in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


class ConfigResolver:
    def __init__(self, raw: dict, device: str | None = None):
        self.raw = raw
        self.device = device
        self.resolved: dict[str, Any] = {}
        self._resolving: set[str] = set()

    def resolve_key(self, key: str) -> Any:
        if key in self.resolved:
            return self.resolved[key]
        if key not in self.raw:
            raise KeyError(f"!ref to unknown config key '{key}'")
        if key in self._resolving:
            raise ValueError(f"circular !ref involving '{key}'")
        self._resolving.add(key)
        try:
            value = self.resolve_node(self.raw[key])
        finally:
            self._resolving.discard(key)
        self.resolved[key] = value
        return value

    def resolve_node(self, node: Any) -> Any:
        if isinstance(node, _Ref):
            return self._resolve_ref(node.expr)
        if isinstance(node, _Name):
            return self._call(node, instantiate=False)
        if isinstance(node, (_New, _Apply)):
            return self._call(node, instantiate=True)
        if isinstance(node, dict):
            return {k: self.resolve_node(v) for k, v in node.items()}
        if isinstance(node, list):
            return [self.resolve_node(v) for v in node]
        return node

    def _resolve_ref(self, expr: str) -> Any:
        expr = expr.strip()
        m = _REF_RE.fullmatch(expr)
        if m:
            return self.resolve_key(m.group(1))
        # string interpolation: every <key> replaced by str(resolved)
        return _REF_RE.sub(lambda match: str(self.resolve_key(match.group(1))), expr)

    def _call(self, node: _Tagged, instantiate: bool) -> Any:
        from .registry import resolve_path

        fn = resolve_path(node.path)
        payload = self.resolve_node(node.payload)
        kw = {}
        if self.device is not None and _takes_device(fn) and not (
                isinstance(payload, dict) and "device" in payload):
            kw["device"] = self.device
        if payload is None:
            args, kwargs = (), kw
        elif isinstance(payload, dict):
            args, kwargs = (), {**payload, **kw}
        elif isinstance(payload, list):
            args, kwargs = tuple(payload), kw
        else:
            args, kwargs = (payload,), kw
        return fn(*args, **kwargs) if instantiate else functools.partial(fn, *args, **kwargs)


def _parse_scalar(text: str) -> Any:
    """A CLI value as ``yaml.safe_load`` reads it; the text itself where it is
    no YAML or lies outside the reader's subset (a date, a base-60 number)."""
    try:
        return load_yaml(text)
    except YAMLError:
        return text


def load_config(path_or_stream, overrides: dict | str | None = None,
                device: str | None = None) -> dict:
    """Load a YAML config, apply overrides, resolve the object graph (the
    objects that take a ``device`` built on ``device``, when given)."""
    if hasattr(path_or_stream, "read"):
        raw = load_raw(path_or_stream.read())
    else:
        with open(path_or_stream) as f:
            raw = load_raw(f.read())
    if overrides:
        if isinstance(overrides, str):
            overrides = load_raw(overrides) or {}
        for k, v in overrides.items():
            raw[k] = v
    resolver = ConfigResolver(raw, device)
    return {k: resolver.resolve_key(k) for k in raw}


def parse_arguments(argv: list[str]):
    """Split argv into (config_path, run_opts, overrides).

    ``recipe.py config.yaml --device cuda --model_type endtoend --lr 0.5``
    Known run options (device, eval_only, ...) go to run_opts; everything
    else becomes a config override — mirroring sb.parse_arguments.
    """
    if not argv:
        raise SystemExit("usage: <recipe> <config.yaml> [--key value ...]")
    config_path = argv[0]
    run_opt_keys = {"device", "eval_only", "debug", "seed_override", "progressbar"}
    run_opts: dict[str, Any] = {}
    overrides: dict[str, Any] = {}
    i = 1
    while i < len(argv):
        arg = argv[i]
        if not arg.startswith("--"):
            raise SystemExit(f"unexpected argument: {arg}")
        key = arg[2:]
        if i + 1 < len(argv) and not argv[i + 1].startswith("--"):
            value = _parse_scalar(argv[i + 1])
            i += 2
        else:
            value = True
            i += 1
        if key in run_opt_keys:
            run_opts[key] = value
        else:
            overrides[key] = value
    return config_path, run_opts, overrides
