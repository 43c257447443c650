from .defaults import (
    ConfigNode,
    export_cfg,
    get_default_cfg,
    load_cfg,
)

__all__ = ["ConfigNode", "get_default_cfg", "load_cfg", "export_cfg"]
