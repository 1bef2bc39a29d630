"""Persistent application settings (counterpart of
``divshot_tpu/core/settings.py``, which is pure Python, copied): the
reference's ini-backed settings store (L0 ``diverse_base`` config/ini_parse;
editor window/session state persistence). Plain INI via configparser:
sections of typed key/values, atomic save, default fallbacks.
"""

from __future__ import annotations

import configparser
import os
import tempfile
from typing import Any


class SettingsStore:
    """INI-file settings with typed get/set and atomic persistence."""

    def __init__(self, path: str, autosave: bool = True):
        self.path = os.path.expanduser(path)
        self.autosave = autosave
        self._cp = configparser.ConfigParser()
        if os.path.exists(self.path):
            self._cp.read(self.path)

    # -- typed access ------------------------------------------------------
    def get(self, section: str, key: str, default: Any = None) -> Any:
        if not self._cp.has_option(section, key):
            return default
        raw = self._cp.get(section, key)
        if isinstance(default, bool):
            return raw.lower() in ("1", "true", "yes", "on")
        if isinstance(default, int):
            return int(raw)
        if isinstance(default, float):
            return float(raw)
        return raw

    def set(self, section: str, key: str, value: Any) -> None:
        if not self._cp.has_section(section):
            self._cp.add_section(section)
        self._cp.set(section, key, str(value))
        if self.autosave:
            self.save()

    def remove(self, section: str, key: str | None = None) -> None:
        if key is None:
            self._cp.remove_section(section)
        elif self._cp.has_section(section):
            self._cp.remove_option(section, key)
        if self.autosave:
            self.save()

    def sections(self) -> list[str]:
        return self._cp.sections()

    def items(self, section: str) -> dict[str, str]:
        if not self._cp.has_section(section):
            return {}
        return dict(self._cp.items(section))

    # -- persistence ---------------------------------------------------------
    def save(self) -> None:
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d or ".", suffix=".ini")
        try:
            with os.fdopen(fd, "w") as f:
                self._cp.write(f)
            os.replace(tmp, self.path)   # atomic on POSIX
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
