"""Athinput parameter-file parser.

A copy of ``atmospheric_athena_tpu/par.py``.  Runtime (tier-2)
configuration system, file-compatible with the reference's ``src/par.c``
so that the reference's ``athinput.*`` decks can be consumed unchanged:

  - blocks introduced by ``<blockname>`` lines,
  - ``name = value  # comment`` entries,
  - later definitions override earlier ones,
  - command-line override syntax ``block/name=value``
    (par_cmdline, src/main.c:218; src/par.c:4-23).

Unlike the reference there is no MPI broadcast step (par_dist_mpi,
src/prototypes.h:188): every process parses the same file.
"""

from __future__ import annotations

import re
from typing import Dict

_BLOCK_RE = re.compile(r"^<\s*([^>]+?)\s*>\s*$")


class ParError(KeyError):
    """Raised when a required parameter is missing (ath_error analogue)."""


class ParameterDB:
    """Block/name -> string value database, mirroring par.c semantics."""

    def __init__(self) -> None:
        self._db: Dict[str, Dict[str, str]] = {}

    # -- construction --------------------------------------------------------

    @classmethod
    def from_file(cls, path: str) -> "ParameterDB":
        with open(path, "r") as fh:
            return cls.from_string(fh.read())

    @classmethod
    def from_string(cls, text: str) -> "ParameterDB":
        self = cls()
        block = None
        for raw in text.splitlines():
            line = raw.split("#", 1)[0].rstrip()
            if not line.strip():
                continue
            m = _BLOCK_RE.match(line.strip())
            if m:
                block = m.group(1)
                # par.c stops reading at <par_end>
                if block == "par_end":
                    break
                self._db.setdefault(block, {})
                continue
            if "=" in line and block is not None:
                name, value = line.split("=", 1)
                self.set(block, name.strip(), value.strip())
        return self

    def apply_cmdline(self, args) -> None:
        """Apply ``block/name=value`` overrides (par_cmdline)."""
        for arg in args:
            if "=" not in arg or "/" not in arg.split("=", 1)[0]:
                continue
            lhs, value = arg.split("=", 1)
            block, name = lhs.split("/", 1)
            self.set(block, name, value)

    # -- accessors (par_get{s,i,d} and _def variants) ------------------------

    def exist_block(self, block: str) -> bool:
        return block in self._db

    def exist(self, block: str, name: str) -> bool:
        return block in self._db and name in self._db[block]

    def set(self, block: str, name: str, value) -> None:
        self._db.setdefault(block, {})[name] = str(value)

    def gets(self, block: str, name: str) -> str:
        try:
            return self._db[block][name]
        except KeyError:
            raise ParError(f"par: <{block}>/{name} not found")

    def geti(self, block: str, name: str) -> int:
        return int(self.gets(block, name), 0)

    def getd(self, block: str, name: str) -> float:
        return float(self.gets(block, name))

    def gets_def(self, block: str, name: str, default: str) -> str:
        return self._db.get(block, {}).get(name, default)

    def geti_def(self, block: str, name: str, default: int) -> int:
        v = self._db.get(block, {}).get(name)
        return default if v is None else int(v, 0)

    def getd_def(self, block: str, name: str, default: float) -> float:
        v = self._db.get(block, {}).get(name)
        return default if v is None else float(v)

    # -- introspection -------------------------------------------------------

    def blocks(self):
        return list(self._db)

    def block_items(self, block: str):
        return dict(self._db.get(block, {}))

    def matching_blocks(self, prefix: str):
        """Blocks named '<prefix>N' sorted by N (e.g. domain1, output2)."""
        out = []
        for b in self._db:
            if b.startswith(prefix) and b[len(prefix):].isdigit():
                out.append((int(b[len(prefix):]), b))
        return [b for _, b in sorted(out)]

    def dump(self) -> str:
        """par_dump analogue: full resolved database as text."""
        lines = []
        for block, kv in self._db.items():
            lines.append(f"<{block}>")
            for k, v in kv.items():
                lines.append(f"{k} = {v}")
            lines.append("")
        return "\n".join(lines)
