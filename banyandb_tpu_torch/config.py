"""Config/flag system with environment binding.

Analog of the reference's viper+pflag setup (pkg/config: every flag is
also settable via environment and config file).  Resolution order, most
specific wins:

    CLI flag  >  BYDB_<NAME> env var  >  --config JSON file  >  default

Units (server roles, engines) register their flags up front; `load`
resolves everything at once and returns an attribute-style namespace.
"""

from __future__ import annotations

import argparse
import json
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Optional

from banyandb_tpu_torch.utils.envflag import env_str


@dataclass(frozen=True)
class Flag:
    name: str  # kebab-case CLI name, e.g. "wire-port"
    default: Any
    help: str = ""
    type: Callable = str
    required: bool = False

    @property
    def env_name(self) -> str:
        return "BYDB_" + self.name.upper().replace("-", "_")

    @property
    def attr(self) -> str:
        return self.name.replace("-", "_")


class Settings(dict):
    __getattr__ = dict.__getitem__


class Config:
    def __init__(self, prog: str = "banyandb-tpu"):
        self.prog = prog
        self._flags: dict[str, Flag] = {}
        self.register("config", None, "JSON config file path")

    def register(
        self,
        name: str,
        default: Any,
        help: str = "",
        type: Optional[Callable] = None,
        required: bool = False,
    ) -> None:
        if name in self._flags:
            raise ValueError(f"flag {name!r} registered twice")
        if type is None:
            type = (
                bool
                if isinstance(default, bool)
                else (builtin_type(default) if default is not None else str)
            )
        self._flags[name] = Flag(name, default, help, type, required)

    def load(self, argv: Optional[list[str]] = None) -> Settings:
        ap = argparse.ArgumentParser(self.prog)
        for f in self._flags.values():
            kwargs: dict = {"help": f"{f.help} [env {f.env_name}]"}
            if f.type is bool:
                # --flag / --no-flag so CLI False can override env/file
                # True (tri-state default None = unresolved)
                kwargs["action"] = argparse.BooleanOptionalAction
                kwargs["default"] = None
            else:
                kwargs["type"] = f.type
                kwargs["default"] = None
            ap.add_argument(f"--{f.name}", dest=f.attr, **kwargs)
        ns = ap.parse_args(argv)

        file_vals: dict = {}
        cfg_path = getattr(ns, "config", None) or env_str("BYDB_CONFIG")
        if cfg_path:
            file_vals = json.loads(Path(cfg_path).read_text())

        out = Settings()
        missing = []
        for f in self._flags.values():
            v = getattr(ns, f.attr)
            if v is None and f.env_name in os.environ:
                raw = os.environ[f.env_name]
                v = (
                    raw.lower() in ("1", "true", "yes", "on")
                    if f.type is bool
                    else f.type(raw)
                )
            if v is None and (f.attr in file_vals or f.name in file_vals):
                # config keys may use either the CLI (kebab) or attribute
                # (snake) spelling, matching the viper/pflag convention
                v = file_vals.get(f.attr, file_vals.get(f.name))
                if v is not None:
                    if f.type is bool:
                        # normalize string bools ("false") like env vars do
                        if isinstance(v, str):
                            v = v.lower() in ("1", "true", "yes", "on")
                        else:
                            v = bool(v)
                    else:
                        v = f.type(v)
            if v is None:
                v = f.default
            if v is None and f.required:
                missing.append(f.name)
            out[f.attr] = v
        if missing:
            ap.error(f"missing required flags: {', '.join(missing)}")
        return out


def builtin_type(v: Any) -> Callable:
    return type(v)
