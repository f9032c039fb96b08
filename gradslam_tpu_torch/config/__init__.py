from .cfgnode import CfgNode

__all__ = ["CfgNode"]
