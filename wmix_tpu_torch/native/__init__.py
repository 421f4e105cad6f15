"""The host C front-ends of the MP3 and AAC decoders, built with the system
C compiler on first use.

Copies of `wmix_tpu/native/`'s `mp3fe.c` and `aacfe.c`, their generated
table headers and the generators, which read the port's own table copies
(`codecs/_mp3_tables.py`, `codecs/_aac_tables.py`).  `load` compiles
`<name>.c` into `build/wmix_tpu_torch/native/lib<name>.so` at the root of
the checkout (git-ignored), and again whenever the source or a dependency
is newer than the library.  Nothing is built on import.  The compiler is
`$CC`, else `gcc`.
"""
from __future__ import annotations

import ctypes
import functools
import os
import subprocess
from pathlib import Path

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent.parent / "build" / "wmix_tpu_torch" / "native"


@functools.lru_cache(maxsize=None)
def load(name: str, cflags: tuple = (), deps: tuple = ()) -> ctypes.CDLL:
    """Compile (if needed) and load lib<name>.so from <name>.c.

    ``deps``: extra files (e.g. generated headers) whose mtimes also
    trigger a rebuild.  ``cflags``: extra compiler flags."""
    src = _DIR / f"{name}.c"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"lib{name}.so"
    newest = max([src.stat().st_mtime] +
                 [Path(d).stat().st_mtime for d in deps])
    if not so.exists() or so.stat().st_mtime < newest:
        cc = os.environ.get("CC", "gcc")
        # build beside the library and rename: concurrent builds (test
        # workers) never load a half-written file
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        subprocess.run(
            [cc, "-O2", "-fPIC", "-shared", *cflags, "-o", str(tmp),
             str(src)],
            check=True)
        os.replace(tmp, so)
    return ctypes.CDLL(str(so))
