"""The frozen reference (`wbench/reference/`) against the port's CPU chain
it was copied from, bit for bit, and the controls against the reference:
the reference computed below the configuration's precision has to come
out not correct."""
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from wbench import check, harness
from wbench.traffic import conversation

CONFIGS = ("record.f16k", "record.i16k")


def _traffic(batch, pkgs, seed):
    p = harness.traffic("conversation.served")["params"]
    return tuple(x.numpy() for x in
                 conversation.generate(batch, pkgs, 16000, seed, p, "cpu"))


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_equals_the_ports_cpu_chain(name):
    from wmix_tpu_torch.engine.chain import RecordChain
    cfg = harness.config(name)
    mic, play = _traffic(6, 12, 41)
    ref = check.reference_outputs(cfg, mic, play, 12)
    with check.mode(cfg):
        port = RecordChain(6, 16000, device="cpu", **cfg["chain"])
    for t in range(12):
        got = port.step(torch.from_numpy(mic[t]), torch.from_numpy(play[t]))
        for r, g in zip(ref, got):
            assert np.array_equal(r[t], g.numpy()), t


def test_reference_imports_nothing_of_the_program():
    code = ("import json, sys; import wbench.reference.engine.chain; "
            "import wbench.check; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    res = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    tops = set(json.loads(res.stdout))
    assert not tops & {"jax", "jaxlib", "flax", "wmix_tpu", "wmix_tpu_torch"}


@pytest.mark.parametrize("name", CONFIGS)
def test_control_is_not_correct(name):
    """The configuration's control over 8 slots and 60 packages of the
    conversation mix: at least one held number beyond its limit."""
    cfg = harness.config(name)
    chk = cfg["check"]
    mic, play = _traffic(8, 60, 7)
    ref = check.reference_outputs(cfg, mic, play, 60)
    ctl = check.reference_outputs(cfg, mic, play, 60, control=chk["control"])
    got = check.numbers(ctl, ref)
    assert any(got[k] > lim for k, lim in chk["limits"].items()), got


# ---------------------------------------------- the copy against wmix_tpu
#
# The copy is held to the port above; what makes it a yardstick is that it
# also gives `wmix_tpu`'s own outputs.  tests/data/torch_parity_ref.json
# keeps, for PARITY_r05's 64 scenes, the SHA-256 of each stream's first
# second of `wmix_tpu`'s output where the chain is bit-equal, and
# tests/data/torch_aec_only_plain_1s.npz the first second of `wmix_tpu`'s
# plain-JAX fast AEC.  The first second of a scene does not depend on its
# length or on the other streams of the batch, so a few streams are
# replayed alone.

PARITY_REF = os.path.join(harness.ROOT, "tests", "data",
                          "torch_parity_ref.json")
PLAIN_1S = os.path.join(harness.ROOT, "tests", "data",
                        "torch_aec_only_plain_1s.npz")
# one stream of each scene kind, at each of the four echo gains
STREAMS = (0, 5, 10, 15, 17, 30, 44, 63)
FULL = dict(ns_enable=True, aec_enable=True, agc_enable=True,
            vad_enable=True)
ONLY = {s: {k: k == s + "_enable" for k in FULL}
        for s in ("ns", "aec", "agc", "vad")}
# configuration of the stored file -> (chain keywords, exact mode)
BIT_EQUAL = {
    "int_chain_nsx_aecm": (dict(FULL, ns_backend="nsx",
                                aec_backend="aecm"), False),
    "full_chain_exact": (FULL, True),
    "agc_only": (ONLY["agc"], False),
    "vad_only": (ONLY["vad"], False),
}


def _parity_scene(n, freq, kind, seed, gain):
    """(play, mic) of one PARITY_r05 scene (parity.py:52-82)."""
    r = np.random.RandomState(seed)
    t = np.arange(n) / freq
    far = (np.sin(2 * np.pi * (300 + 40 * (seed % 7)) * t) * 6000 +
           np.sin(2 * np.pi * (170 + 23 * (seed % 5)) * t) * 3000 *
           (np.sin(2 * np.pi * 1.3 * t + seed) > 0))
    speech = (np.sin(2 * np.pi * (220 + 31 * (seed % 3)) * t) * 4000 *
              (np.sin(2 * np.pi * 0.7 * t + seed * 0.7) > 0.3))
    noise = r.randn(n) * 80
    delay = freq // 100 + (seed % 3) * 16
    echo = np.zeros(n)
    echo[delay:] = far[:n - delay] * gain
    play = far if kind in ("echo", "fartalk") else np.zeros(n)
    mic = {"echo": echo + speech + noise, "fartalk": echo + noise,
           "noecho": speech + noise, "silence": noise}[kind]
    return tuple(np.clip(x, -32768, 32767).astype(np.int16)
                 for x in (play, mic))


def _first_second(chain_kw, exact):
    """The reference's origin output, int16 [len(STREAMS), 16000], over
    the first second of the stored scenes."""
    with open(PARITY_REF) as f:
        scenes = json.load(f)["scenes"]
    pairs = [_parity_scene(16000, 16000, scenes[b]["kind"],
                           scenes[b]["seed"], scenes[b]["gain"])
             for b in STREAMS]
    play = np.stack([p for p, _ in pairs]).reshape(len(STREAMS), 50, 320)
    mic = np.stack([m for _, m in pairs]).reshape(len(STREAMS), 50, 320)
    cfg = {"reference": "wbench.reference.engine.chain", "freq": 16000,
           "mode": "exact" if exact else "fast", "chain": chain_kw}
    origin, _, _ = check.reference_outputs(
        cfg, np.ascontiguousarray(mic.transpose(1, 0, 2)),
        np.ascontiguousarray(play.transpose(1, 0, 2)), 50)
    return origin.transpose(1, 0, 2).reshape(len(STREAMS), 16000)


@pytest.mark.parametrize("name", sorted(BIT_EQUAL))
def test_reference_is_bit_equal_to_wmix_tpu(name):
    """The digests of the first second equal `wmix_tpu`'s, stream by
    stream, in every configuration where the port is bit-equal to it."""
    chain_kw, exact = BIT_EQUAL[name]
    with open(PARITY_REF) as f:
        want = json.load(f)["configs"][name]["wmix_tpu_digest"]
    got = _first_second(chain_kw, exact)
    for i, b in enumerate(STREAMS):
        row = np.ascontiguousarray(got[i], dtype="<i2")
        assert hashlib.sha256(row.tobytes()).hexdigest()[:16] == \
            want[b][0], (name, b)


def test_reference_fast_aec_within_1_lsb_of_wmix_tpu_plain():
    """The fast AEC alone (the float chain's AEC, in the form the card's
    kernel computes) within 1 LSB of `wmix_tpu`'s plain-JAX fast path
    over the first second."""
    with np.load(PLAIN_1S) as z:
        want = z["out"][list(STREAMS)].astype(np.int32)
    got = _first_second(ONLY["aec"], False).astype(np.int32)
    assert int(np.abs(got - want).max()) <= 1
