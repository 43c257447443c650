from .defaults import (
    ConfigNode,
    check_port_support,
    export_cfg,
    get_default_cfg,
    load_cfg,
)

__all__ = ["ConfigNode", "check_port_support", "get_default_cfg", "load_cfg",
           "export_cfg"]
