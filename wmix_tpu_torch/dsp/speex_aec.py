"""Speex echo canceller (speex-1.2beta3 mdf.c) — the daemon's alternate
AEC backend (MAKE_SPEEX_BETA3, src/speexType.c + src/wmix.c:660-676).

The deployment is peculiar and reproduced exactly:
  * spx_aec_init passes delayms=0 (src/wmix.c:665), so the MDF filter
    has M = 0 partitions — no echo path is ever modelled.  The entire
    output chain reduces to DC-notch -> pre-emphasis -> saturation ->
    de-emphasis, and THAT path is ported bit-exactly (float32 ops in the
    reference order; tests gate vs the compiled beta3 library).
  * spx_aec_process (speexType.c:99-141) loads the far-end frame into a
    buffer it then never passes to speex: speex_echo_cancellation is
    called with the OUTPUT buffer as the far end (previous frame's
    output, zeros on the first call).  Faithfully mirrored.

For completeness the full MDF update (M > 0: AUMDF weight adaptation,
two-path foreground/background logic, leak estimation) is implemented
too, with the drft transform mapped onto numpy's rfft in FFTPACK
packing; the M > 0 path is functionally equivalent but not bit-gated
(the deployed configuration never reaches it) — tests hold it to a
correlation bound vs the compiled reference.
"""
from __future__ import annotations

import numpy as np

F32 = np.float32

MIN_LEAK = F32(0.005)
VAR1_SMOOTH = F32(0.36)
VAR2_SMOOTH = F32(0.7225)
VAR1_UPDATE = F32(0.5)
VAR2_UPDATE = F32(0.25)
VAR_BACKTRACK = F32(4.0)


def _f32(x):
    return np.float32(x)


class SpeexEchoState:
    """speex_echo_state_init (mdf.c:381-496); float build, the default
    8000 Hz profile (spx_aec_init never sets the sampling rate, so
    notch_radius stays 0.9 and beta/spec_average use 8000)."""

    def __init__(self, frame_size: int, filter_length: int):
        self.frame_size = frame_size
        self.window_size = N = 2 * frame_size
        self.M = M = (filter_length + frame_size - 1) // frame_size
        self.cancel_count = 0
        self.sum_adapt = F32(0)
        self.saturated = 0
        self.screwed_up = 0
        self.sampling_rate = 8000
        self.spec_average = _f32(frame_size) / _f32(self.sampling_rate)
        self.beta0 = _f32(2.0 * frame_size) / _f32(self.sampling_rate)
        self.beta_max = _f32(0.5 * frame_size) / _f32(self.sampling_rate)
        self.leak_estimate = F32(0)

        z = lambda n: np.zeros(n, F32)
        self.e = z(N)
        self.x = z(N)
        self.input = z(frame_size)
        self.y = z(N)
        self.last_y = z(N)
        self.Yf = z(frame_size + 1)
        self.Rf = z(frame_size + 1)
        self.Xf = z(frame_size + 1)
        self.Yh = z(frame_size + 1)
        self.Eh = z(frame_size + 1)
        self.X = z((M + 1, N))
        self.Y = z(N)
        self.E = z(N)
        self.W = z((M, N))
        self.foreground = z((M, N))
        self.Davg1 = F32(0)
        self.Davg2 = F32(0)
        self.Dvar1 = F32(0)
        self.Dvar2 = F32(0)
        self.PHI = z(N)
        self.power = z(frame_size + 1)
        self.power_1 = np.ones(frame_size + 1, F32)
        self.window = (F32(0.5) - F32(0.5) * np.cos(
            2 * np.pi * np.arange(N) / N).astype(F32)).astype(F32)
        self.prop = z(max(M, 1))
        if M > 0:
            decay = _f32(np.exp(np.float32(-2.4) / _f32(M)))
            self.prop[0] = F32(0.7)
            s = self.prop[0]
            for i in range(1, M):
                self.prop[i] = F32(self.prop[i - 1] * decay)
                s = F32(s + self.prop[i])
            for i in range(M - 1, -1, -1):
                self.prop[i] = F32(F32(0.8) * self.prop[i] / s)
        self.memX = F32(0)
        self.memD = F32(0)
        self.memE = F32(0)
        self.preemph = F32(0.9)
        self.notch_radius = F32(0.9)
        self.notch_mem = [F32(0), F32(0)]
        self.adapted = 0
        self.Pey = F32(1)
        self.Pyy = F32(1)

    def reset(self):
        """speex_echo_state_reset (mdf.c:498-540)."""
        self.cancel_count = 0
        self.screwed_up = 0
        self.W[:] = 0
        self.foreground[:] = 0
        self.X[:] = 0
        self.power[:] = 0
        self.power_1[:] = 1
        self.Eh[:] = 0
        self.Yh[:] = 0
        self.last_y[:self.frame_size] = 0
        self.E[:] = 0
        self.x[:] = 0
        self.notch_mem = [F32(0), F32(0)]
        self.memX = self.memD = self.memE = F32(0)
        self.saturated = 0
        self.adapted = 0
        self.sum_adapt = F32(0)
        self.Pey = F32(1)
        self.Pyy = F32(1)
        self.Davg1 = self.Davg2 = F32(0)
        self.Dvar1 = self.Dvar2 = F32(0)


def _filter_dc_notch16(x_int16, radius, mem):
    """filter_dc_notch16 (mdf.c:190-206), float path, sequential."""
    den2 = F32(radius * radius +
               F32(F32(0.7) * F32((F32(1) - radius) * (F32(1) - radius))))
    out = np.empty(len(x_int16), F32)
    m0, m1 = mem
    for i, v in enumerate(np.asarray(x_int16, F32)):
        vout = F32(m0 + v)
        m0 = F32(m1 + F32(2) * F32(-v + F32(radius * vout)))
        m1 = F32(v - F32(den2 * vout))
        out[i] = F32(min(F32(radius * vout), F32(32767.0)))
    mem[0], mem[1] = m0, m1
    return out


def _inner_prod(x, y):
    """mdf_inner_prod (mdf.c:209-222): pairwise MACs then /64 shifts are
    fixed-point only; the float build is a plain ordered fold of pairs."""
    x = np.asarray(x, F32)
    y = np.asarray(y, F32)
    n = (len(x) >> 1) << 1
    s = F32(0)
    for i in range(0, n, 2):
        part = F32(F32(x[i] * y[i]) + F32(x[i + 1] * y[i + 1]))
        s = F32(s + part)
    return s


def _power_spectrum(X, n):
    ps = np.empty(n // 2 + 1, F32)
    ps[0] = F32(X[0] * X[0])
    re = X[1:n - 1:2]
    im = X[2:n - 1:2]
    ps[1:-1] = (re * re + im * im).astype(F32)
    ps[-1] = F32(X[n - 1] * X[n - 1])
    return ps


def _spx_fft(x):
    """spx_fft via smallft drft: scale by 1/N then forward transform;
    FFTPACK packing [DC, r1, i1, ..., Nyq].  Mapped onto numpy rfft
    (float64 internally) — used only by the M>0 adaptation path."""
    n = len(x)
    X = np.fft.rfft(np.asarray(x, np.float64) / n)
    out = np.empty(n, F32)
    out[0] = X[0].real
    out[1:n - 1:2] = X[1:n // 2].real
    out[2:n - 1:2] = X[1:n // 2].imag
    out[n - 1] = X[n // 2].real
    return out


def _spx_ifft(X):
    n = len(X)
    spec = np.empty(n // 2 + 1, np.complex128)
    spec[0] = X[0]
    spec[1:n // 2] = X[1:n - 1:2] + 1j * X[2:n - 1:2]
    spec[n // 2] = X[n - 1]
    return np.fft.irfft(spec, n).astype(F32) * F32(n)


def echo_cancellation(st: SpeexEchoState, inp: np.ndarray,
                      far_end: np.ndarray) -> np.ndarray:
    """speex_echo_cancellation (mdf.c:646-1108), float build.

    The M == 0 output path (the wmix deployment) is float32-exact; the
    M > 0 adaptation runs through the rfft-mapped transform."""
    fs = st.frame_size
    N = st.window_size
    M = st.M
    st.cancel_count += 1
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        ss = F32(F32(0.35) / _f32(M)) if M else F32(np.inf)
        ss_1 = F32(F32(1) - ss)

        inp = np.asarray(inp, np.int16)
        far = np.asarray(far_end, np.int16)

        st.input = _filter_dc_notch16(inp, st.notch_radius, st.notch_mem)
        # pre-emphasis on far + near (float: no saturation flags)
        farf = far.astype(F32)
        xs = np.empty(fs, F32)
        memX = st.memX
        for i in range(fs):
            xs[i] = F32(farf[i] - F32(st.preemph * memX))
            memX = farf[i]
        st.memX = memX
        st.x[fs:] = xs
        dinp = np.empty(fs, F32)
        memD = st.memD
        for i in range(fs):
            dinp[i] = F32(st.input[i] - F32(st.preemph * memD))
            memD = st.input[i]
        st.memD = memD
        st.input = dinp

        # shift far history
        if M > 0:
            st.X[1:M + 1] = st.X[0:M]
        st.X[0] = _spx_fft(st.x)
        st.last_y[:] = st.x
        Sxx = _inner_prod(st.x[fs:], st.x[fs:])
        st.x[:fs] = st.x[fs:]

        # foreground filter response
        Y = _smul_accum(st.X, st.foreground, N, M)
        e_full = _spx_ifft(Y)
        st.e = e_full
        st.e[:fs] = (st.input - st.e[fs:]).astype(F32)
        Sff = _inner_prod(st.e[:fs], st.e[:fs])

        if M > 0:
            _adjust_prop(st.W, N, M, st.prop)
            if st.saturated == 0:
                for j in range(M - 1, -1, -1):
                    p = F32(st.prop[j] / F32(32768.0) * F32(32768.0))
                    # float build: PSEUDOFLOAT/FLOAT_SHL are identity
                    W = (st.power_1 * st.prop[j]).astype(F32)
                    Xj = st.X[j + 1]
                    E = st.E
                    phi = np.empty(N, F32)
                    phi[0] = F32(W[0] * F32(Xj[0] * E[0]))
                    re = (Xj[1:N - 1:2] * E[1:N - 1:2] +
                          Xj[2:N - 1:2] * E[2:N - 1:2]).astype(F32)
                    im = (-Xj[2:N - 1:2] * E[1:N - 1:2] +
                          Xj[1:N - 1:2] * E[2:N - 1:2]).astype(F32)
                    phi[1:N - 1:2] = (W[1:fs] * re).astype(F32)
                    phi[2:N - 1:2] = (W[1:fs] * im).astype(F32)
                    phi[N - 1] = F32(W[fs] * F32(Xj[N - 1] * E[N - 1]))
                    st.W[j] = (st.W[j] + phi).astype(F32)
            else:
                st.saturated -= 1

            # AUMDF circular-convolution constraint
            for j in range(M):
                if j == 0 or (M > 1 and
                              st.cancel_count % (M - 1) == j - 1):
                    wtmp = _spx_ifft(st.W[j])
                    wtmp[fs:] = 0
                    st.W[j] = _spx_fft(wtmp)

        Y = _smul_accum(st.X, st.W, N, M)
        st.Y = Y
        st.y = _spx_ifft(Y)

        st.e[:fs] = (st.e[fs:] - st.y[fs:]).astype(F32)
        Dbf = F32(F32(10) + _inner_prod(st.e[:fs], st.e[:fs]))
        st.e[:fs] = (st.input - st.y[fs:]).astype(F32)
        See = _inner_prod(st.e[:fs], st.e[:fs])

        # two-path foreground/background logic
        st.Davg1 = F32(F32(0.6) * st.Davg1 +
                       F32(F32(0.4) * F32(Sff - See)))
        st.Davg2 = F32(F32(0.85) * st.Davg2 +
                       F32(F32(0.15) * F32(Sff - See)))
        st.Dvar1 = F32(VAR1_SMOOTH * st.Dvar1 +
                       F32(F32(0.4) * Sff) * F32(F32(0.4) * Dbf))
        st.Dvar2 = F32(VAR2_SMOOTH * st.Dvar2 +
                       F32(F32(0.15) * Sff) * F32(F32(0.15) * Dbf))

        update_foreground = 0
        d = F32(Sff - See)
        if F32(d * abs(d)) > F32(Sff * Dbf):
            update_foreground = 1
        elif F32(st.Davg1 * abs(st.Davg1)) > F32(VAR1_UPDATE * st.Dvar1):
            update_foreground = 1
        elif F32(st.Davg2 * abs(st.Davg2)) > F32(VAR2_UPDATE * st.Dvar2):
            update_foreground = 1

        if update_foreground:
            st.Davg1 = st.Davg2 = F32(0)
            st.Dvar1 = st.Dvar2 = F32(0)
            st.foreground[:] = st.W
            st.e[fs:] = (st.window[fs:] * st.e[fs:] +
                         st.window[:fs] * st.y[fs:]).astype(F32)
        else:
            reset_background = 0
            if F32(F32(-d) * abs(d)) > F32(VAR_BACKTRACK *
                                           F32(Sff * Dbf)):
                reset_background = 1
            if F32(F32(-st.Davg1) * abs(st.Davg1)) > \
                    F32(VAR_BACKTRACK * st.Dvar1):
                reset_background = 1
            if F32(F32(-st.Davg2) * abs(st.Davg2)) > \
                    F32(VAR_BACKTRACK * st.Dvar2):
                reset_background = 1
            if reset_background:
                st.W[:] = st.foreground
                st.y[fs:] = st.e[fs:]
                st.e[:fs] = (st.input - st.y[fs:]).astype(F32)
                See = Sff
                st.Davg1 = st.Davg2 = F32(0)
                st.Dvar1 = st.Dvar2 = F32(0)

        # output with de-emphasis (sequential memE recursion)
        out = np.empty(fs, np.int16)
        memE = st.memE
        for i in range(fs):
            tmp = F32(st.input[i] - st.e[fs + i])
            if tmp > 32767.0:
                tmp = F32(32767.0)
            elif tmp < -32768.0:
                tmp = F32(-32768.0)
            tmp = F32(tmp + F32(st.preemph * memE))
            if inp[i] <= -32000 or inp[i] >= 32000:
                tmp = F32(0)
                if st.saturated == 0:
                    st.saturated = 1
            out[i] = np.int16(int(tmp))
            memE = tmp
        st.memE = memE

        st.e[fs:] = st.e[:fs]
        st.e[:fs] = 0

        Sey = _inner_prod(st.e[fs:], st.y[fs:])
        Syy = _inner_prod(st.y[fs:], st.y[fs:])
        Sdd = _inner_prod(st.input, st.input)

        if (not (Syy >= 0 and Sxx >= 0 and See >= 0)) or \
                not (Sff < N * 1e9 and Syy < N * 1e9 and Sxx < N * 1e9):
            st.screwed_up += 50
            out[:] = 0
        elif F32(Sff / 4) > F32(Sdd + F32(N * 10000) / 64):
            st.screwed_up += 1
        else:
            st.screwed_up = 0
        if st.screwed_up >= 50:
            st.reset()
            return out

        See = F32(max(See, F32(N * 100) / 64))

        st.E = _spx_fft(st.e)
        st.y[:fs] = 0
        st.Y = _spx_fft(st.y)

        st.Rf = _power_spectrum(st.E, N)
        st.Yf = _power_spectrum(st.Y, N)
        st.Xf = _power_spectrum(st.X[0], N)

        st.power = (ss_1 * st.power + F32(1) + ss * st.Xf).astype(F32)

        Pey = F32(1)
        Pyy = F32(1)
        for j in range(fs, -1, -1):
            Eh = F32(st.Rf[j] - st.Eh[j])
            Yh = F32(st.Yf[j] - st.Yh[j])
            Pey = F32(Pey + F32(Eh * Yh))
            Pyy = F32(Pyy + F32(Yh * Yh))
            st.Eh[j] = F32((F32(1) - st.spec_average) * st.Eh[j] +
                           st.spec_average * st.Rf[j])
            st.Yh[j] = F32((F32(1) - st.spec_average) * st.Yh[j] +
                           st.spec_average * st.Yf[j])

        Pyy = F32(np.sqrt(np.float64(Pyy)))
        Pey = F32(Pey / Pyy)

        tmp32 = F32(st.beta0 * Syy)
        if tmp32 > F32(st.beta_max * See):
            tmp32 = F32(st.beta_max * See)
        alpha = F32(tmp32 / See)
        alpha_1 = F32(F32(1) - alpha)
        st.Pey = F32(alpha_1 * st.Pey + alpha * Pey)
        st.Pyy = F32(alpha_1 * st.Pyy + alpha * Pyy)
        if st.Pyy < 1:
            st.Pyy = F32(1)
        if st.Pey < F32(MIN_LEAK * st.Pyy):
            st.Pey = F32(MIN_LEAK * st.Pyy)
        if st.Pey > st.Pyy:
            st.Pey = st.Pyy
        st.leak_estimate = F32(st.Pey / st.Pyy)

        RER = F32((F32(0.0001) * Sxx + F32(3) *
                   F32(st.leak_estimate * Syy)) / See)
        bound = F32(F32(Sey * Sey) / F32(1 + F32(See * Syy)))
        if RER < bound:
            RER = bound
        if RER > 0.5:
            RER = F32(0.5)

        if (not st.adapted and st.sum_adapt > M and
                F32(st.leak_estimate * Syy) > F32(F32(0.03) * Syy)):
            st.adapted = 1

        if st.adapted:
            r = (st.leak_estimate * st.Yf).astype(F32)
            e = (st.Rf + F32(1)).astype(F32)
            r = np.minimum(r, F32(0.5) * e).astype(F32)
            r = (F32(0.7) * r + F32(0.3) * (RER * e)).astype(F32)
            st.power_1 = (r / (e * (st.power + F32(10)))).astype(F32)
        else:
            adapt_rate = F32(0)
            if Sxx > F32(F32(N * 1000) / 64):
                tmp32 = F32(F32(0.25) * Sxx)
                if tmp32 > F32(0.25) * See:
                    tmp32 = F32(F32(0.25) * See)
                adapt_rate = F32(tmp32 / See)
            st.power_1 = (adapt_rate /
                          (st.power + F32(10))).astype(F32)
            st.sum_adapt = F32(st.sum_adapt + adapt_rate)

        if st.adapted:
            st.last_y[:fs] = st.last_y[fs:]
            st.last_y[fs:] = (inp - out).astype(F32)
    return out


def _smul_accum(X, W, N, M):
    """spectral_mul_accum, float path (mdf.c:295-315)."""
    acc = np.zeros(N, F32)
    for j in range(M):
        Xj = X[j]
        Wj = W[j]
        acc[0] = F32(acc[0] + F32(Xj[0] * Wj[0]))
        re = (Xj[1:N - 1:2] * Wj[1:N - 1:2] -
              Xj[2:N - 1:2] * Wj[2:N - 1:2]).astype(F32)
        im = (Xj[2:N - 1:2] * Wj[1:N - 1:2] +
              Xj[1:N - 1:2] * Wj[2:N - 1:2]).astype(F32)
        acc[1:N - 1:2] = (acc[1:N - 1:2] + re).astype(F32)
        acc[2:N - 1:2] = (acc[2:N - 1:2] + im).astype(F32)
        acc[N - 1] = F32(acc[N - 1] + F32(Xj[N - 1] * Wj[N - 1]))
    return acc


def _adjust_prop(W, N, M, prop):
    """mdf_adjust_prop (mdf.c:334-362), float path."""
    max_sum = F32(1)
    for i in range(M):
        tmp = F32(1)
        for v in W[i]:
            tmp = F32(tmp + F32(v * v))
        prop[i] = F32(np.sqrt(np.float64(tmp)))
        if prop[i] > max_sum:
            max_sum = prop[i]
    prop_sum = F32(1)
    for i in range(M):
        prop[i] = F32(prop[i] + F32(0.1) * max_sum)
        prop_sum = F32(prop_sum + prop[i])
    for i in range(M):
        prop[i] = F32(F32(0.99) * prop[i] / prop_sum)


# --------------------------------------------------------------------------
# daemon wrapper (src/speexType.c)
# --------------------------------------------------------------------------

class SpxAecProcessor:
    """spx_aec_init/process/release (speexType.c:43-157), including the
    reference's far-end plumbing quirk (see module docstring)."""

    def __init__(self, chn: int, freq: int, interval_ms: int,
                 delayms: int = 0):
        if freq > 16000 or freq % 8000 != 0:
            raise ValueError("spx_aec: freq must be 8000/16000")
        self.chn = chn
        self.freq = freq
        if freq <= 8000:
            self.interval_ms = 20 if interval_ms % 20 == 0 else 10
        else:
            self.interval_ms = 10
        self.pkg_frame = freq // 1000 * self.interval_ms
        self.st = SpeexEchoState(self.pkg_frame, delayms)
        self.out_buf = np.zeros(self.pkg_frame, np.int16)

    def process2(self, frame_far: np.ndarray,
                 frame_near: np.ndarray) -> np.ndarray:
        """spx_aec_process (speexType.c:99-141): interleaved int16 in/out
        of frame_num*chn samples; left channel only, duplicated out."""
        far = np.asarray(frame_far, np.int16).reshape(-1, self.chn)
        near = np.asarray(frame_near, np.int16).reshape(-1, self.chn)
        n_frames = near.shape[0]
        out = np.empty((n_frames, self.chn), np.int16)
        for off in range(0, n_frames, self.pkg_frame):
            seg = near[off:off + self.pkg_frame, 0]
            # the C passes sas->out[0] (the PREVIOUS output, zeros at
            # first) as speex's far_end; sas->far is filled and dropped
            res = echo_cancellation(self.st, seg, self.out_buf)
            self.out_buf = res
            out[off:off + self.pkg_frame] = res[:, None]
        return out.reshape(-1)
