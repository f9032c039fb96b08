"""YACS-style configuration tree (a copy of gradslam_tpu.config.cfgnode).

``yaml`` is imported by the functions that read or write YAML, not at
import time, so the module loads where PyYAML is missing.

Parity surface with the reference's CfgNode
(reference: gradslam/config/cfgnode.py:37 — itself YACS/fvcore-derived):
an attribute-accessible dict tree with YAML / Python-module loading, deep
merging with type coercion, freezing, deprecated/renamed key registries,
and literal-eval value decoding. Implemented fresh, same behavior surface.
"""

from __future__ import annotations

import copy
import importlib.util
import io
import logging
from ast import literal_eval
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

__all__ = ["CfgNode"]

_VALID_TYPES = {tuple, list, str, int, float, bool, type(None)}


class CfgNode(dict):
    """A configuration node: dict subclass with attribute access, freezing,
    and recursive merge.

    Example:
        >>> cfg = CfgNode({"SLAM": {"odom": "gradicp", "numiters": 20}})
        >>> cfg.SLAM.numiters
        20
        >>> cfg.freeze()
    """

    IMMUTABLE = "__immutable__"
    DEPRECATED_KEYS = "__deprecated_keys__"
    RENAMED_KEYS = "__renamed_keys__"
    NEW_ALLOWED = "__new_allowed__"

    def __init__(
        self,
        init_dict: Optional[Dict] = None,
        key_list: Optional[List[str]] = None,
        new_allowed: bool = False,
    ):
        init_dict = {} if init_dict is None else init_dict
        key_list = [] if key_list is None else key_list
        init_dict = self._create_config_tree_from_dict(init_dict, key_list)
        super().__init__(init_dict)
        self.__dict__[CfgNode.IMMUTABLE] = False
        self.__dict__[CfgNode.DEPRECATED_KEYS] = set()
        self.__dict__[CfgNode.RENAMED_KEYS] = {}
        self.__dict__[CfgNode.NEW_ALLOWED] = new_allowed

    @classmethod
    def _create_config_tree_from_dict(cls, dic, key_list):
        dic = copy.deepcopy(dic)
        for k, v in dic.items():
            if isinstance(v, dict):
                dic[k] = cls(v, key_list=key_list + [str(k)])
            else:
                _assert_valid_type(v, key_list + [str(k)])
        return dic

    # -- attribute access ------------------------------------------------
    def __getattr__(self, name):
        if name in self:
            return self[name]
        raise AttributeError(
            f"Attribute {name!r} not found in CfgNode"
        )

    def __setattr__(self, name, value):
        if self.is_frozen():
            raise AttributeError(
                f"Attempted to set {name!r} but CfgNode is immutable"
            )
        _assert_valid_type(value, [name])
        self[name] = value

    # -- immutability ----------------------------------------------------
    def freeze(self):
        """Makes this node and all children immutable."""
        self._immutable(True)

    def defrost(self):
        """Makes this node and all children mutable."""
        self._immutable(False)

    def is_frozen(self):
        return self.__dict__[CfgNode.IMMUTABLE]

    def _immutable(self, is_immutable: bool):
        self.__dict__[CfgNode.IMMUTABLE] = is_immutable
        for v in self.values():
            if isinstance(v, CfgNode):
                v._immutable(is_immutable)

    def is_new_allowed(self):
        return self.__dict__[CfgNode.NEW_ALLOWED]

    # -- cloning / dumping ----------------------------------------------
    def clone(self):
        return copy.deepcopy(self)

    def dump(self, **kwargs) -> str:
        """Dumps to a YAML string."""

        def to_dict(node):
            if not isinstance(node, CfgNode):
                _assert_valid_type(node, ["dump"])
                return node
            return {k: to_dict(v) for k, v in node.items()}

        import yaml

        return yaml.safe_dump(to_dict(self), **kwargs)

    def __str__(self):
        def _indent(s, n=2):
            lines = s.split("\n")
            return "\n".join(
                [lines[0]] + [" " * n + l for l in lines[1:]]
            )

        parts = []
        for k, v in sorted(self.items()):
            sep = "\n" if isinstance(v, CfgNode) else " "
            parts.append(_indent(f"{k}:{sep}{v}"))
        return "\n".join(parts)

    def __repr__(self):
        return f"{type(self).__name__}({super().__repr__()})"

    # -- loading ---------------------------------------------------------
    @classmethod
    def load_cfg(cls, cfg_file_obj_or_str):
        """Loads from a YAML string/file object, or a .py module path whose
        ``cfg`` attribute is a dict/CfgNode."""
        import yaml

        if isinstance(cfg_file_obj_or_str, str):
            return cls(yaml.safe_load(cfg_file_obj_or_str) or {})
        if isinstance(cfg_file_obj_or_str, io.IOBase) or hasattr(
            cfg_file_obj_or_str, "read"
        ):
            name = getattr(cfg_file_obj_or_str, "name", "")
            if name.endswith(".py"):
                return cls._load_cfg_py_source(name)
            return cls(yaml.safe_load(cfg_file_obj_or_str.read()) or {})
        raise TypeError(
            f"cannot load cfg from {type(cfg_file_obj_or_str)}"
        )

    @classmethod
    def load_cfg_from_file(cls, filename: str):
        if filename.endswith(".py"):
            return cls._load_cfg_py_source(filename)
        import yaml

        with open(filename) as f:
            return cls(yaml.safe_load(f) or {})

    @classmethod
    def _load_cfg_py_source(cls, filename: str):
        spec = importlib.util.spec_from_file_location("_cfg_module", filename)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        if not hasattr(module, "cfg"):
            raise AttributeError(
                f"python config {filename} must define a 'cfg' attribute"
            )
        cfg = module.cfg
        if isinstance(cfg, cls):
            return cfg.clone()
        if isinstance(cfg, dict):
            return cls(cfg)
        raise TypeError(
            f"'cfg' in {filename} must be a dict or CfgNode, got {type(cfg)}"
        )

    # -- merging ---------------------------------------------------------
    def merge_from_file(self, cfg_filename: str):
        """Merges a YAML (or .py) config file into this node."""
        other = self.load_cfg_from_file(cfg_filename)
        self.merge_from_other_cfg(other)

    def merge_from_other_cfg(self, cfg_other: "CfgNode"):
        _merge_a_into_b(cfg_other, self, self, [])

    def merge_from_list(self, cfg_list: List[Any]):
        """Merges from a flat list: ['KEY.SUBKEY', value, ...]."""
        if len(cfg_list) % 2 != 0:
            raise ValueError(
                f"override list has odd length {len(cfg_list)}"
            )
        for full_key, v in zip(cfg_list[0::2], cfg_list[1::2]):
            if self.key_is_deprecated(full_key):
                continue
            if self.key_is_renamed(full_key):
                self.raise_key_rename_error(full_key)
            key_parts = full_key.split(".")
            d = self
            for sub in key_parts[:-1]:
                if sub not in d:
                    raise KeyError(f"Non-existent key: {full_key}")
                d = d[sub]
            sub = key_parts[-1]
            if sub not in d:
                raise KeyError(f"Non-existent key: {full_key}")
            value = self._decode_cfg_value(v)
            value = _check_and_coerce_cfg_value_type(
                value, d[sub], sub, full_key
            )
            d[sub] = value

    # -- deprecated / renamed keys ---------------------------------------
    def register_deprecated_key(self, key: str):
        if key in self.__dict__[CfgNode.DEPRECATED_KEYS]:
            raise KeyError(f"key {key} already registered as deprecated")
        self.__dict__[CfgNode.DEPRECATED_KEYS].add(key)

    def register_renamed_key(
        self, old_name: str, new_name: str, message: Optional[str] = None
    ):
        if old_name in self.__dict__[CfgNode.RENAMED_KEYS]:
            raise KeyError(f"key {old_name} already registered as renamed")
        value = (new_name, message) if message else new_name
        self.__dict__[CfgNode.RENAMED_KEYS][old_name] = value

    def key_is_deprecated(self, full_key: str) -> bool:
        if full_key in self.__dict__[CfgNode.DEPRECATED_KEYS]:
            logger.warning("deprecated config key (ignoring): %s", full_key)
            return True
        return False

    def key_is_renamed(self, full_key: str) -> bool:
        return full_key in self.__dict__[CfgNode.RENAMED_KEYS]

    def raise_key_rename_error(self, full_key: str):
        new_key = self.__dict__[CfgNode.RENAMED_KEYS][full_key]
        if isinstance(new_key, tuple):
            msg = f" Note: {new_key[1]}"
            new_key = new_key[0]
        else:
            msg = ""
        raise KeyError(
            f"key {full_key} was renamed to {new_key};"
            f" please update your config.{msg}"
        )

    # -- value decoding ---------------------------------------------------
    @classmethod
    def _decode_cfg_value(cls, value):
        """Decodes a raw override value: dicts become CfgNodes, strings go
        through literal_eval when possible."""
        if isinstance(value, dict):
            return cls(value)
        if not isinstance(value, str):
            return value
        try:
            return literal_eval(value)
        except (ValueError, SyntaxError):
            return value


def _assert_valid_type(value, key_list):
    if type(value) in _VALID_TYPES or isinstance(value, CfgNode):
        return
    raise AttributeError(
        "invalid config value type {} for key {}; valid types: {}".format(
            type(value), ".".join(key_list), _VALID_TYPES
        )
    )


def _merge_a_into_b(a: CfgNode, b: CfgNode, root: CfgNode, key_list):
    """Recursively merges node a into node b (reference cfgnode.py:427)."""
    if not isinstance(a, CfgNode) or not isinstance(b, CfgNode):
        raise TypeError("both arguments must be CfgNode")
    for k, v_ in a.items():
        full_key = ".".join(key_list + [str(k)])
        v = copy.deepcopy(v_)
        v = b._decode_cfg_value(v)
        if k in b:
            v = _check_and_coerce_cfg_value_type(v, b[k], k, full_key)
            if isinstance(v, CfgNode):
                _merge_a_into_b(v, b[k], root, key_list + [str(k)])
            else:
                b[k] = v
        elif b.is_new_allowed():
            b[k] = v
        else:
            if root.key_is_deprecated(full_key):
                continue
            if root.key_is_renamed(full_key):
                root.raise_key_rename_error(full_key)
            raise KeyError(f"Non-existent config key: {full_key}")


def _check_and_coerce_cfg_value_type(replacement, original, key, full_key):
    """Checks replacement/original type compatibility with list<->tuple and
    str coercions (reference cfgnode.py:464-493)."""
    original_type = type(original)
    replacement_type = type(replacement)
    if replacement_type == original_type or original is None:
        return replacement
    # numeric cross-coercion (int -> float is safe)
    if isinstance(replacement, int) and isinstance(original, float):
        return float(replacement)
    casts = [(tuple, list), (list, tuple)]
    for src, dst in casts:
        if replacement_type == src and original_type == dst:
            return dst(replacement)
    raise ValueError(
        "type mismatch ({} vs. {}) for key {}: {} vs {}".format(
            original_type, replacement_type, full_key, original, replacement
        )
    )
