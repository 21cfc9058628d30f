"""The program's configuration for a cell, and the plain sections the
reference reads."""

from __future__ import annotations

import dataclasses

SECTIONS = ("model", "data", "infer", "train")


def program_config(cell):
    """The program's config for the cell: the configuration file's section
    for the mix's driver (``train``: its preset, overrides and
    stated settings) plus the mix's overrides; raises where it departs from
    a setting the file states."""
    from basi_tpu_torch.config import get_config

    role = cell.traffic["driver"]
    conf = cell.config[role]
    cfg = get_config(conf["preset"], list(conf.get("overrides", []))
                     + list(cell.traffic.get("overrides", [])))
    for sec in SECTIONS:
        got = dataclasses.asdict(getattr(cfg, sec))
        for key, want in conf.get(sec, {}).items():
            have = got[key]
            have = list(have) if isinstance(have, tuple) else have
            if have != want:
                raise ValueError(f"{cell.config['name']}: {role} {sec}.{key} "
                                 f"runs as {have!r}, the file states "
                                 f"{want!r}")
    return cfg


def plain_config(cfg) -> dict:
    """The sections the reference reads, as plain dicts."""
    return {sec: dataclasses.asdict(getattr(cfg, sec)) for sec in SECTIONS}
