"""Console-variable registry (counterpart of ``divshot_tpu/core/cmdvars.py``,
which is pure Python, copied): the reference's ``CmdVariable`` /
``CmadVariableMgr`` (``utility/cmd_variable.h:11-43``; usage e.g.
``r.enableOutline``, ``renderer/gaussian.cpp:13``): named, typed, runtime-
tweakable settings with change callbacks, settable from code / CLI /
environment (DIVSHOT_CVAR_<name>)."""

from __future__ import annotations

import os
import threading
from typing import Any, Callable


class CmdVar:
    def __init__(self, name: str, default: Any, help: str = ""):
        self.name = name
        self.default = default
        self.type = type(default)
        self.help = help
        self._value = default
        self._callbacks: list[Callable[[Any], None]] = []

    @property
    def value(self) -> Any:
        return self._value

    def set(self, value: Any) -> None:
        if self.type is bool and isinstance(value, str):
            value = value.lower() in ("1", "true", "yes", "on")
        self._value = self.type(value)
        for cb in self._callbacks:
            cb(self._value)

    def on_change(self, cb: Callable[[Any], None]) -> None:
        self._callbacks.append(cb)


class CmdVarRegistry:
    """Thread-safe singleton registry."""

    _instance: "CmdVarRegistry | None" = None
    _lock = threading.Lock()

    def __init__(self):
        self._vars: dict[str, CmdVar] = {}

    @classmethod
    def instance(cls) -> "CmdVarRegistry":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def register(self, name: str, default: Any, help: str = "") -> CmdVar:
        if name in self._vars:
            return self._vars[name]
        var = CmdVar(name, default, help)
        env = os.environ.get(
            "DIVSHOT_CVAR_" + name.replace(".", "_").upper())
        if env is not None:
            var.set(env)
        self._vars[name] = var
        return var

    def get(self, name: str) -> CmdVar | None:
        return self._vars.get(name)

    def set(self, name: str, value: Any) -> None:
        if name not in self._vars:
            raise KeyError(f"unknown cvar {name}")
        self._vars[name].set(value)

    def all(self) -> dict[str, CmdVar]:
        return dict(self._vars)

    def apply_cli(self, pairs: list[str]) -> None:
        """['r.enableOutline=1', ...]"""
        for pair in pairs:
            name, _, val = pair.partition("=")
            self.set(name.strip(), val.strip())


def cvar(name: str, default: Any, help: str = "") -> CmdVar:
    """Module-level convenience: register (or fetch) a console variable."""
    return CmdVarRegistry.instance().register(name, default, help)


# renderer toggles mirroring the reference's cvars
ENABLE_OUTLINE = cvar("r.enableOutline", True,
                      "draw selection outlines in edit renders")
VIDEO_EXPORT_THREADS = cvar("r.videoExportThreads", 4,
                            "video encoder worker count")
