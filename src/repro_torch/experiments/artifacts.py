"""Versioned JSON experiment artifacts.

One artifact holds an ordered list of experiment records (see
``runner.run_spec``) under a schema version, written with sorted keys and
full float repr so a byte-identical rerun produces a byte-identical file —
the property the golden-artifact CI gate relies on.
"""
from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

SCHEMA_VERSION = 1
KIND = "repro-experiment-artifact"

PathLike = Union[str, Path]


class ArtifactError(ValueError):
    pass


def make_artifact(experiments: Sequence[Dict],
                  meta: Optional[Dict] = None) -> Dict:
    return {
        "kind": KIND,
        "schema_version": SCHEMA_VERSION,
        "meta": dict(meta or {}),
        "experiments": list(experiments),
    }


def write(path: PathLike, experiments: Sequence[Dict],
          meta: Optional[Dict] = None) -> Dict:
    art = make_artifact(experiments, meta)
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    # sort_keys + fixed separators => canonical bytes; json floats use
    # repr() which round-trips IEEE doubles exactly.  Written to a temp
    # file in the same directory and renamed into place: a crashed or
    # colliding writer can never leave a truncated file that read() (and
    # hence compare) would mistake for a complete artifact.
    fd, tmp = tempfile.mkstemp(dir=p.parent, prefix=p.name + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as fh:
            fh.write(json.dumps(art, sort_keys=True, indent=1) + "\n")
        os.replace(tmp, p)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return art


def read(path: PathLike) -> Dict:
    p = Path(path)
    try:
        art = json.loads(p.read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise ArtifactError(f"cannot read artifact {p}: {e}") from e
    if not isinstance(art, dict) or art.get("kind") != KIND:
        raise ArtifactError(f"{p} is not a {KIND}")
    version = art.get("schema_version")
    if version != SCHEMA_VERSION:
        raise ArtifactError(
            f"{p}: schema_version {version} != supported {SCHEMA_VERSION}")
    return art


def experiments_by_name(art: Dict) -> Dict[str, Dict]:
    return {e["name"]: e for e in art.get("experiments", [])}
