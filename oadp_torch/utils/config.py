"""Python-file config system with ``_base_`` inheritance and dotted overrides.

Reimplements the config semantics the reference gets from ``todd.Config``
(used at reference ``oadp/oake/base.py:66-72``, ``oadp/dp/train.py:18-24``;
config files under reference ``configs/``):

* configs are Python files whose module-level variables form a dict;
* ``_base_ = ['a.py', 'b.py']`` deep-merges parent configs (later bases and
  the child override earlier values);
* a dict containing ``_delete_: True`` replaces the base value instead of
  merging (reference ``configs/dp/datasets/ov_lvis.py:19``);
* CLI overrides use ``.dotted.path:value`` pairs where the value is a Python
  literal (reference ``README.md:216``).
"""

__all__ = ['Config', 'DictAction', 'parse_override']

import argparse
import ast
import copy
import pathlib
import pprint
from typing import Any, Iterable

_DELETE = '_delete_'
_BASE = '_base_'


class Config(dict):
    """A dict with attribute access and deep-merge semantics."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        del self[name]

    def copy(self) -> 'Config':
        return copy.deepcopy(self)

    # -- construction ------------------------------------------------------

    @classmethod
    def _wrap(cls, value: Any) -> Any:
        if isinstance(value, dict) and not isinstance(value, Config):
            value = cls({k: cls._wrap(v) for k, v in value.items()})
        elif isinstance(value, dict):
            for k, v in value.items():
                value[k] = cls._wrap(v)
        elif isinstance(value, (list, tuple)):
            value = type(value)(cls._wrap(v) for v in value)
        return value

    @classmethod
    def load(cls, path: str | pathlib.Path) -> 'Config':
        path = pathlib.Path(path)
        namespace: dict[str, Any] = {}
        code = compile(path.read_text(), str(path), 'exec')
        exec(code, namespace)
        config = cls._wrap({
            k: v
            for k, v in namespace.items()
            if not k.startswith('__') and not callable(v)
        })
        bases = config.pop(_BASE, [])
        merged = cls()
        for base in bases:
            merged = cls.merge(merged, cls.load(path.parent / base))
        return cls.merge(merged, config)

    @classmethod
    def merge(cls, base: Any, override: Any) -> Any:
        """Deep-merge ``override`` onto ``base`` (override wins)."""
        if not isinstance(override, dict):
            return copy.deepcopy(override)
        if not isinstance(base, dict) or override.pop(_DELETE, False):
            base = cls()
        result = cls({k: copy.deepcopy(v) for k, v in base.items()})
        for k, v in override.items():
            result[k] = cls.merge(result.get(k), v)
        return result

    # -- overrides ---------------------------------------------------------

    def override(self, options: dict[str, Any]) -> None:
        """Apply ``{'.dotted.path': value}`` overrides in place."""
        for path, value in options.items():
            keys = [k for k in path.split('.') if k]
            target: Any = self
            for key in keys[:-1]:
                key = int(key) if _is_int(key) else key
                if isinstance(target, dict) and key not in target:
                    target[key] = Config()
                target = target[key]
            last = keys[-1]
            last = int(last) if _is_int(last) else last
            target[last] = self._wrap(value)

    # -- serialization -----------------------------------------------------

    def dumps(self) -> str:
        return '\n'.join(
            f'{k} = {pprint.pformat(_plain(v))}' for k, v in self.items()
        )

    def dump(self, path: str | pathlib.Path) -> None:
        pathlib.Path(path).write_text(self.dumps() + '\n')


def _is_int(s: str) -> bool:
    try:
        int(s)
        return True
    except ValueError:
        return False


def _plain(value: Any) -> Any:
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_plain(v) for v in value)
    return value


def parse_override(pairs: Iterable[str]) -> dict[str, Any]:
    """Parse ``.dotted.path:value`` strings; values are Python literals."""
    options: dict[str, Any] = {}
    for pair in pairs:
        path, _, raw = pair.partition(':')
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        options[path] = value
    return options


class DictAction(argparse.Action):
    """argparse action collecting ``.dotted.path:value`` override pairs."""

    def __call__(self, parser, namespace, values, option_string=None):
        if isinstance(values, str):
            values = [values]
        existing = getattr(namespace, self.dest, None) or {}
        existing.update(parse_override(values))
        setattr(namespace, self.dest, existing)
