"""Engine geometry and timing configuration.

The port's own copy of `wmix_tpu/config.py` (tested equal to it on every
derived size).  The reference fixes these at compile time per platform
(platform/alsa/plat.h:15-21, src/wmixConf.h:109-144); here they are one
runtime dataclass.  All sizes follow the reference's formulas so parity
tests line up byte for byte.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Geometry of one mix engine (one virtual sound card).

    Mirrors the reference's WMIX_* constants (src/wmixConf.h:111-124):
      chn          — engine channel count        (WMIX_CHN)
      freq         — engine sample rate, Hz      (WMIX_FREQ)
      sample       — bits per sample, 16 only    (WMIX_SAMPLE)
      interval_ms  — package interval            (WMIX_INTERVAL_MS, 20)
      aec_interval_ms — echo-path delay the AEC is aligned to
                        (PLAT_AEC_INTERVALMS, alsa default 400)
    """

    chn: int = 1
    freq: int = 8000
    sample: int = 16
    interval_ms: int = 20
    aec_interval_ms: int = 400
    # platform write-ahead override; None = the alsa 0.2 s formula.
    # The t31 platform pins it to 0 (platform/t31/plat.h:16).
    play_correct_override: int | None = None
    # The reference picks AEC/NS variants at COMPILE time
    # (MAKE_WEBRTC_AEC vs MAKE_SPEEX_BETA3, src/webrtc.c:172-191; NS vs
    # NSX :511-530); the rebuild makes them per-engine config.
    aec_backend: str = "webrtc"     # "webrtc" | "aecm" | "speex"
    ns_backend: str = "ns"          # "ns" | "nsx"

    def __post_init__(self):
        if self.sample != 16:
            raise ValueError("only 16-bit engines exist (WMIX_SAMPLE=16)")
        if self.interval_ms < 10 or self.interval_ms % 10:
            raise ValueError("interval_ms must be >=10 and a multiple of 10")
        if self.chn not in (1, 2):
            raise ValueError("chn must be 1 or 2")
        if self.aec_backend not in ("webrtc", "aecm", "speex"):
            raise ValueError("aec_backend must be webrtc/aecm/speex")
        if self.ns_backend not in ("ns", "nsx"):
            raise ValueError("ns_backend must be ns/nsx")

    # --- derived sizes, formulas from src/wmixConf.h:115-124 ---

    @property
    def frame_size(self) -> int:
        """Bytes per frame (one sample per channel)."""
        return self.chn * self.sample // 8

    @property
    def frame_num(self) -> int:
        """Frames per package (one interval)."""
        return self.freq * self.interval_ms // 1000

    @property
    def pkg_size(self) -> int:
        """Bytes per package."""
        return self.frame_size * self.frame_num

    @property
    def buff_size(self) -> int:
        """Play ring buffer bytes (1 s of audio)."""
        return self.frame_size * self.freq

    @property
    def ring_frames(self) -> int:
        """Play ring length in frames."""
        return self.freq

    @property
    def play_correct(self) -> int:
        """Write-ahead placement of a fresh mix cursor, in bytes (0.2 s);
        alsa formula PLAT_PLAY_CORRECT (platform/alsa/plat.h:21), or the
        platform override (t31 pins 0, platform/t31/plat.h:16)."""
        if self.play_correct_override is not None:
            return self.play_correct_override
        return self.chn * self.freq * 16 // 8 // 5

    @classmethod
    def t31(cls, **kw) -> "EngineConfig":
        """The Ingenic T31 geometry (platform/t31/plat.h:10-16): mono
        8 kHz, hardware AEC (zero echo-path delay), no write-ahead."""
        kw.setdefault("chn", 1)
        kw.setdefault("freq", 8000)
        kw.setdefault("aec_interval_ms", 0)
        kw.setdefault("play_correct_override", 0)
        return cls(**kw)

    @property
    def aec_fifo_pkgs(self) -> int:
        """Far-end history FIFO depth in packages (src/wmixConf.h:141)."""
        return self.aec_interval_ms // self.interval_ms + 2
