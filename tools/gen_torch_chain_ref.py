"""Reference outputs of `wmix_tpu`'s exact-mode RecordChain for the
geometries whose live JAX chain is too dear for the default tests.

    python tools/gen_torch_chain_ref.py [case ...]

runs `wmix_tpu.engine.chain.RecordChain` on the CPU under x64 with
WMIX_EXACT=1 for each case of `CASES` (all of them without arguments) on
audio made from the case's seed, and writes
`tests/data/torch_chain_exact_<case>.npz`: the int16 `origin` and 8 kHz
packages and the VAD flags of every package, and, of the final state, one
SHA-256 per leaf with the leaf's name (the AEC's far-end stores alone
would be 100 KB a case in full).  A chain costs one XLA program per plan
signature, one to four CPU-minutes a case.

tests/test_torch_chain_exact.py holds wmix_tpu_torch's exact chain
bit-equal to these files, and a test there marked `slow` calls
`reference_run` again and compares it with the file.

The chains with an integer backend (`INT_CASES`: NSX and AECM, alone and
together) are stored the same way as `tests/data/torch_chain_int_<case>
.npz`, from `int_audio`; tests/test_torch_chain_int.py holds the port to
them.  A chain with both integer backends does not depend on the mode.
For the cases of `SNAPSHOT_CASES` the file also holds `snapshot`, the
bytes of `wmix_tpu.engine.checkpoint.snapshot` of the chain after
`n_pkgs // 2` packages, which the port must restore and run on from.
"""
from __future__ import annotations

import hashlib
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_DIR = os.path.join(REPO, "tests", "data")

B = 2
# name -> (freq, chain keywords, packages, seed)
CASES = {
    "16k_mono": (16000, {}, 8, 101),
    "16k_stereo": (16000, dict(chn=2), 8, 102),
    "8k_mono": (8000, {}, 8, 103),
    "8k_stereo_100ms": (8000, dict(chn=2, aec_interval_ms=100, part_cap=32),
                        8, 104),
    "16k_10ms": (16000, dict(interval_ms=10, aec_enable=False), 8, 105),
    "32k_stereo": (32000, dict(chn=2), 5, 106),
}


# the integer backends; a 60 ms echo path, so that the far end reaches
# the AECM within the run
_INT = dict(aec_backend="aecm", ns_backend="nsx", aec_interval_ms=60)
INT_CASES = {
    "int_16k_mono": (16000, _INT, 12, 201),
    "int_8k_mono": (8000, _INT, 12, 202),
    "int_16k_stereo": (16000, dict(_INT, chn=2), 12, 203),
    "aecm_ns_16k": (16000, dict(aec_backend="aecm", aec_interval_ms=60), 10,
                    204),
    "aec_nsx_16k": (16000, dict(ns_backend="nsx"), 8, 205),
    "nsx_32k_stereo": (32000, dict(ns_backend="nsx", chn=2), 6, 206),
}


SNAPSHOT_CASES = ("int_16k_mono",)

# The fast chain with wmix_tpu's Pallas package kernel (interpret mode on
# the CPU), as tests/test_torch_chain.py holds the port to it: B = 2, a
# chunk of 9 packages (3 start-up, 1 irregular, 5 steady) and a chunk of
# 5 steady ones.  Both chunks hold 5 steady packages, so the reference
# compiles its steady program once.
FAST_CASE = "fast_pallas_16k"
FAST_CHUNK_LENS = (9, 5)


def path_of(case: str) -> str:
    kind = "int" if case in INT_CASES else \
        "fast" if case == FAST_CASE else "exact"
    return os.path.join(DATA_DIR, f"torch_chain_{kind}_{case}.npz")


def fast_audio():
    """(mic, play) int16 [14, B, 320] of the fast case: seeded Gaussian
    noise, as tests/test_aec_pallas.py makes its audio."""
    rng = np.random.RandomState(0)
    n = sum(FAST_CHUNK_LENS)
    mic = (rng.randn(n, B, 320) * 3000).astype(np.int16)
    play = (rng.randn(n, B, 320) * 5000).astype(np.int16)
    return mic, play


def tree_from_leaves(names, arrays):
    """The nested structure that `jax.tree_util.keystr` names describe
    (".ns.noise", ".aec.p['wf_re']"): attributes become namespaces, keys
    dicts; what `wmix_tpu_torch.engine.chain.state_from_numpy` reads."""
    import re
    from types import SimpleNamespace
    root = SimpleNamespace()
    for name, arr in zip(names, arrays):
        parts = re.findall(r"\.(\w+)|\['([^']+)'\]", str(name))
        node = root
        for (attr, key), (_, next_key) in zip(parts, parts[1:]):
            child = {} if next_key else SimpleNamespace()
            if attr:
                if not hasattr(node, attr):
                    setattr(node, attr, child)
                node = getattr(node, attr)
            else:
                node = node.setdefault(key, child)
        attr, key = parts[-1]
        if attr:
            setattr(node, attr, arr)
        else:
            node[key] = arr
    return root


def _jax_on_cpu():
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_allow_excess_precision" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_allow_excess_precision=false").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    return jax


def fast_reference_run() -> dict:
    """The fast case through `wmix_tpu` (WMIX_FAST=1, WMIX_PALLAS=1, x64 as
    the tests run it): each chunk's outputs (`origin0`, `pkg8k0`,
    `vflags0`, then `...1`) and every leaf of the state between the two
    chunks in full (`state1_names`, `state1_<i>`)."""
    os.environ["WMIX_FAST"] = "1"
    os.environ["WMIX_PALLAS"] = "1"
    os.environ.pop("WMIX_EXACT", None)
    jax = _jax_on_cpu()
    from wmix_tpu.engine.chain import RecordChain
    mic, play = fast_audio()
    ch = RecordChain(B, 16000)
    out, lo = {}, 0
    for c, n in enumerate(FAST_CHUNK_LENS):
        if c == 1:
            leaves = jax.tree_util.tree_flatten_with_path(ch.state)[0]
            out["state1_names"] = np.array(
                [jax.tree_util.keystr(p) for p, _ in leaves])
            out.update({f"state1_{i}": np.array(x)
                        for i, (_, x) in enumerate(leaves)})
        o = ch.run_chunk(mic[lo:lo + n], play[lo:lo + n])
        for nm, v in zip(("origin", "pkg8k", "vflags"), o):
            out[f"{nm}{c}"] = np.asarray(v)
        lo += n
    return out


def load_fast_reference() -> dict:
    """The stored fast case as the live reference gave it: `outs`, one
    (origin, pkg8k, vflags) per chunk, and `state1`, the state between the
    chunks as a tree of numpy arrays."""
    with np.load(path_of(FAST_CASE)) as z:
        names = z["state1_names"]
        return dict(
            outs=[[z[f"{nm}{c}"] for nm in ("origin", "pkg8k", "vflags")]
                  for c in range(len(FAST_CHUNK_LENS))],
            state1=tree_from_leaves(
                names, [z[f"state1_{i}"] for i in range(len(names))]))


def int_audio(case: str):
    """(mic, play) int16 [K, B, pkg_len * chn] of an integer case: a far end
    of noise bursts, and a microphone that hears a tone, noise and the far
    end's package of three ticks before at half level."""
    freq, kw, n_pkgs, seed = INT_CASES[case]
    chn = kw.get("chn", 1)
    n = freq // 1000 * 20
    rng = np.random.RandomState(seed)
    burst = rng.uniform(0, 1, (n_pkgs, B, 1, 1)) > 0.3
    play = rng.randn(n_pkgs, B, n, chn) * 6000 * burst
    t = (np.arange(n_pkgs * n).reshape(n_pkgs, 1, n, 1)) / freq
    tone = 2000 * np.sin(2 * np.pi * rng.uniform(200, 1500, (1, B, 1, chn))
                         * t)
    echo = np.zeros_like(play)
    echo[3:] = 0.5 * play[:-3]
    mic = tone + rng.randn(n_pkgs, B, n, chn) * 500 + echo
    mic[n_pkgs // 2, 0] = 0        # a silent package on one stream

    def cast(x):
        return np.clip(np.round(x), -32768, 32767).astype(np.int16).reshape(
            n_pkgs, B, n * chn)
    return cast(mic), cast(play)


def audio(case: str):
    """(mic, play) int16 [K, B, pkg_len * chn], interleaved: a far end of
    noise bursts and a microphone that hears a tone, noise and the far
    end's echo."""
    freq, kw, n_pkgs, seed = CASES[case]
    chn = kw.get("chn", 1)
    n = freq // 1000 * kw.get("interval_ms", 20)
    rng = np.random.RandomState(seed)
    play = rng.randn(n_pkgs, B, n, chn) * 5000
    t = (np.arange(n_pkgs * n).reshape(n_pkgs, 1, n, 1)) / freq
    tone = 2500 * np.sin(2 * np.pi * rng.uniform(200, 1500, (1, B, 1, chn))
                         * t)
    mic = tone + rng.randn(n_pkgs, B, n, chn) * 800 + \
        0.4 * np.roll(play, 23, axis=2)

    def cast(x):
        return np.clip(np.round(x), -32768, 32767).astype(np.int16).reshape(
            n_pkgs, B, n * chn)
    return cast(mic), cast(play)


def leaf_digest(arr: np.ndarray) -> str:
    arr = np.ascontiguousarray(arr)
    h = hashlib.sha256()
    h.update(f"{arr.dtype.str}{arr.shape}".encode())
    h.update(arr.tobytes())
    return h.hexdigest()


def reference_run(case: str) -> dict:
    """The case through `wmix_tpu` in exact mode: outputs, final-state
    digests and leaf names, as arrays ready for `np.savez_compressed`."""
    os.environ["WMIX_EXACT"] = "1"
    os.environ.pop("WMIX_FAST", None)
    jax = _jax_on_cpu()
    from wmix_tpu.dsp import floatops
    from wmix_tpu.engine.chain import RecordChain
    assert not floatops.fast_mode()
    if case in INT_CASES:
        freq, kw, n_pkgs, _seed = INT_CASES[case]
        mic, play = int_audio(case)
    else:
        freq, kw, n_pkgs, _seed = CASES[case]
        mic, play = audio(case)
    ch = RecordChain(B, freq, **kw)
    outs, extra = [], {}
    for k in range(n_pkgs):
        if k == n_pkgs // 2 and case in SNAPSHOT_CASES:
            from wmix_tpu.engine import checkpoint
            extra["snapshot"] = np.frombuffer(checkpoint.snapshot(ch),
                                              np.uint8)
        outs.append([np.asarray(v) for v in ch.step(mic[k], play[k])])
    leaves = jax.tree_util.tree_flatten_with_path(ch.state)[0]
    return dict(
        origin=np.stack([o[0] for o in outs]).astype(np.int16),
        pkg8k=np.stack([o[1] for o in outs]).astype(np.int16),
        vflags=np.stack([o[2] for o in outs]).astype(np.int32),
        leaf_names=np.array([jax.tree_util.keystr(p) for p, _ in leaves]),
        leaf_sha256=np.array([leaf_digest(np.asarray(x))
                              for _, x in leaves]), **extra)


def main(argv) -> None:
    import subprocess
    import time
    sys.path.insert(0, REPO)
    os.makedirs(DATA_DIR, exist_ok=True)
    cases = argv or list(CASES) + list(INT_CASES) + [FAST_CASE]
    for case in cases:
        t0 = time.time()
        if case == FAST_CASE and len(cases) > 1:
            # fast mode in a process of its own: wmix_tpu reads its mode
            # when it traces, and keeps the first trace
            subprocess.run([sys.executable, __file__, case], check=True)
            continue
        data = fast_reference_run() if case == FAST_CASE else \
            reference_run(case)
        np.savez_compressed(path_of(case), **data)
        print(f"{case}: {os.path.getsize(path_of(case))} bytes, "
              f"{time.time() - t0:.0f} s", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
