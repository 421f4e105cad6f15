"""Two-party calls: every slot is one call, its far talker played to the
room and its near talker at the microphone, made in torch on the device
from the run's seed.

Who talks when follows ITU-T P.59's conversation: four states, the near
talker alone, the far talker alone, both (double talk) and neither
(mutual silence), each held for an exponentially distributed time.
Double talk and mutual silence have P.59's mean durations and shares of
the conversation (`double_talk`, `mutual_silence`); a single talk ends in
double talk with the probability and lasts the mean that make those
shares come out (`conversation_model`), and a double talk or a mutual
silence hands the turn to either talker alike.

Levels: each talker's active speech level (ITU-T P.56: the level over
the time the talker is active) is `speech_dbov` dBov, 0 dBov being the
RMS of a full-scale square wave (ITU-T G.100.1), so a full-scale sine is
-3 dBov.  The echo is the far talker delayed by the echo path and
attenuated by the echo return loss `erl_db` (ITU-T G.168).  The mic also
hears Gaussian room noise of `noise_dbov`.

Inside a talkspurt the voice is synthetic, not recorded: `harmonics`
harmonics of a pitch drawn per talker in `pitch_hz`, falling as 1/k, under
a syllable-rate envelope; it is scaled so that its RMS over the talkspurt
is the active speech level.

    generate(batch, n_pkgs, freq, seed, params, device)
        -> (mic, play), int16 [n_pkgs, batch, 20 ms package] on `device`
"""
from __future__ import annotations

import math

import torch

NEAR, FAR, BOTH, NEITHER = range(4)
CHUNK_PKGS = 25          # packages made per step (bounds the temporaries)
N_STATES = 96            # conversation states drawn per slot


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def conversation_model(p: dict) -> dict:
    """Mean durations (s) of the four states, the share of time in each,
    and the probability that a single talk ends in double talk, from
    P.59's double talk and mutual silence (mean seconds, share)."""
    t_d, s_d = p["double_talk"]
    t_m, s_m = p["mutual_silence"]
    # a single talk is left for double talk (p) or mutual silence (1 - p);
    # both of those lead back to a single talk, so visits stand p : 1 - p
    r = s_d / s_m
    to_double = r * t_m / (t_d + r * t_m)
    s_single = (1.0 - s_d - s_m) / 2
    t_single = 2 * s_single / s_m * (1 - to_double) * t_m
    return {"mean_s": (t_single, t_single, t_d, t_m),
            "share": (s_single, s_single, s_d, s_m),
            "to_double": to_double}


def draw_calls(batch: int, freq: int, seed: int, p: dict, device):
    """The per-slot draws: each call's state sequence and the end of each
    state in samples [batch, N_STATES]; each talker's pitch and syllable
    phase; the echo delay in samples.  Returns (draws, generator)."""
    g = _generator(seed, device)
    m = conversation_model(p)
    mean = torch.tensor(m["mean_s"], dtype=torch.float64, device=device)
    share = torch.tensor(m["share"], dtype=torch.float64, device=device)
    u = torch.rand((batch, 2 * N_STATES), generator=g, device=device,
                   dtype=torch.float64)
    state = torch.empty((batch, N_STATES), dtype=torch.long, device=device)
    # the first state from the shares of time, so a call is met mid-way
    state[:, 0] = torch.searchsorted(share.cumsum(0),
                                     u[:, 0].contiguous()).clamp(max=3)
    for i in range(1, N_STATES):
        prev, x = state[:, i - 1], u[:, i]
        single = prev <= FAR
        turn = torch.where(x < 0.5, NEAR, FAR)
        state[:, i] = torch.where(
            single, torch.where(x < m["to_double"], BOTH, NEITHER), turn)
    dur = -mean[state] * torch.log1p(-u[:, N_STATES:])
    end = torch.round(dur.cumsum(1) * freq)
    v = torch.rand((5, batch), generator=g, device=device,
                   dtype=torch.float64)
    lo, hi = p["pitch_hz"]
    delay = freq // 1000 * p["echo_delay_ms"] + \
        torch.floor(v[4] * (p["echo_delay_extra_samples"] + 1))
    return dict(state=state, end=end,
                pitch=lo + (hi - lo) * v[0:2],          # near, far
                syllable_phase=2 * math.pi * v[2:4],
                delay=delay), g


def _level(dbov: float) -> float:
    """The RMS of a level in dBov (0 dBov: a full-scale square wave)."""
    return 32768.0 * 10.0 ** (dbov / 20.0)


def generate(batch: int, n_pkgs: int, freq: int, seed: int, p: dict,
             device):
    """(mic, play) int16 [n_pkgs, batch, freq // 50] on `device`."""
    d, g = draw_calls(batch, freq, seed, p, device)
    pkg = freq // 1000 * 20
    mic = torch.empty((n_pkgs, batch, pkg), dtype=torch.int16,
                      device=device)
    play = torch.empty_like(mic)
    k = torch.arange(1, p["harmonics"] + 1, dtype=torch.float64,
                     device=device)
    lo_env, hi_env = p["syllable_envelope"]
    # the envelope is (lo + hi) / 2 + (hi - lo) / 2 sin(.), of mean
    # square (lo + hi)^2 / 4 + (hi - lo)^2 / 8
    env_ms = (lo_env + hi_env) ** 2 / 4 + (hi_env - lo_env) ** 2 / 8
    voice_gain = _level(p["speech_dbov"]) / math.sqrt(
        env_ms * float((0.5 / k ** 2).sum()))
    echo_gain = 10.0 ** (-p["erl_db"] / 20.0)
    noise_rms = _level(p["noise_dbov"])
    two_pi = 2 * math.pi
    state, end = d["state"], d["end"]

    def talker(n, who):
        """Talker `who` (0 near, 1 far) at sample times n [B, N]."""
        active_in = (NEAR, BOTH) if who == 0 else (FAR, BOTH)
        idx = torch.searchsorted(end, n.clamp(min=0).contiguous(),
                                 right=True).clamp(max=N_STATES - 1)
        s = state.gather(1, idx)
        on = (s == active_in[0]) | (s == active_in[1])
        t = n / freq
        phase = torch.remainder(two_pi * d["pitch"][who][:, None] * t,
                                two_pi).float()
        wave = torch.zeros_like(phase)
        for kk in k.tolist():
            wave += torch.sin(kk * phase) / kk
        env = (lo_env + hi_env) / 2 + (hi_env - lo_env) / 2 * torch.sin(
            two_pi * p["syllable_hz"] * t +
            d["syllable_phase"][who][:, None])
        return voice_gain * env * wave.double() * (on & (n >= 0))

    for p0 in range(0, n_pkgs, CHUNK_PKGS):
        p1 = min(p0 + CHUNK_PKGS, n_pkgs)
        n = torch.arange(p0 * pkg, p1 * pkg, dtype=torch.float64,
                         device=device)[None, :].expand(batch, -1)
        far = talker(n, 1)
        echo = talker(n - d["delay"][:, None], 1) * echo_gain
        noise = torch.randn((batch, n.shape[1]), generator=g,
                            device=device, dtype=torch.float64) * noise_rms
        m = talker(n, 0) + echo + noise

        def put(dst, x):
            # clipped, then truncated toward zero
            x = x.clamp(-32768, 32767).to(torch.int16)
            dst[p0:p1] = x.view(batch, p1 - p0, pkg).transpose(0, 1)
        put(mic, m)
        put(play, far)
    return mic, play
