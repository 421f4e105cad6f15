"""Task workers (src/wmixTask.c): one thread per job, spawned by the
daemon's message dispatcher.  Each mirrors its C counterpart's loop
structure: loopWord generation-counter kills, per-task SysV message
queues for ctrl/kill, reduceMode arbitration (first-wins), and the
mix-ring write pacing."""
from __future__ import annotations

import errno
import os
import stat
import threading
import time
from typing import Optional

import numpy as np

from wmix_tpu_torch.codecs import wav as wavc
from wmix_tpu_torch.io_ import rtp
from wmix_tpu_torch.ops import g711, resample
from wmix_tpu_torch.service import sysv
from wmix_tpu_torch.service.mem import MemReader

# WMIX_CTRL_TYPE (src/wmixConf.h:99-107)
WCT_CLEAR = 1
WCT_STOP = 2
WCT_RESET = 3
WCT_SILENCE = 4


def _split_cstr(value: bytes, offset: int):
    """Read a NUL-terminated string at offset; returns (str, next_off)."""
    end = value.index(0, offset)
    return value[offset:end].decode(), end + 1


class _TaskMsg:
    """Per-task SysV queue at /tmp/wmix/<id> (wmix_load_task
    src/wmixTask.c pattern): killing = destroying the queue."""

    def __init__(self, msg_path: str, note: str):
        self.path = msg_path or None
        self.fd = None
        if not self.path:
            return
        if not os.path.exists(self.path):
            open(self.path, "a").close()
        with open(self.path, "w") as f:
            f.write(note)
        try:
            key = sysv.ftok(self.path, sysv.MSG_ID)
            self.fd = sysv.msgget(key, sysv.IPC_CREAT | 0o666)
        except OSError:
            self.fd = None

    def poll(self):
        """Returns ctrl type (int) or None; raises _Killed when the
        queue was destroyed."""
        if self.fd is None:
            return None
        try:
            got = sysv.msgrcv(self.fd)
        except OSError:
            raise _Killed()
        if got is None:
            return None
        return got[0] & 0xFF

    def describe(self, note: str) -> None:
        """Rewrite the /tmp/wmix/<id> descriptor (wmix_write_file)."""
        if self.path:
            with open(self.path, "w") as f:
                f.write(note)

    def close(self):
        if self.fd is not None:
            sysv.msgctl_rmid(self.fd)
            self.fd = None
        if self.path and os.path.exists(self.path):
            os.remove(self.path)


class _Killed(Exception):
    pass


# ---------------------------------------------------------------------
# play dispatcher (wmix_load_task, src/wmix.c:298-430)
# ---------------------------------------------------------------------

def load_task(wmix, mtype: int, value: bytes):
    audio_path, off = _split_cstr(value, 0)
    try:
        msg_path, _ = _split_cstr(value, off)
    except ValueError:
        msg_path = ""
    order = mtype & 0xFF
    reduce = (mtype >> 8) & 0x0F
    interval = (mtype >> 16) & 0xFF
    repeat = (mtype >> 24) & 0x7F
    loop_word = wmix.loop_word

    wmix.thread_play += 1
    tm = _TaskMsg(msg_path, f"play {audio_path}")
    run = True
    join_queue = False
    queue = -1
    try:
        # queue discipline: only plain FIRST/LAST (no reduce, no
        # interval) line up; MIX and MUTEX play immediately
        if order in (9, 10) and reduce == 0 and interval == 0:
            run = False
            join_queue = True
            if order == 9 and wmix.queue.head != wmix.queue.tail:
                queue = wmix.queue.head
                wmix.queue.head -= 1
            else:
                queue = wmix.queue.tail
                wmix.queue.tail += 1
            while wmix.run and loop_word == wmix.loop_word:
                if queue == wmix.queue.head and \
                        wmix.queue.on_play_count == 0:
                    run = True
                    break
                time.sleep(0.1)
        if run:
            if join_queue:
                wmix.queue.on_play_count += 1
            ext = audio_path.rsplit(".", 1)[-1].lower() \
                if "." in audio_path else ""
            if ext == "aac":
                play_aac(wmix, audio_path, tm, reduce, interval, repeat,
                         loop_word)
            elif ext == "mp3":
                play_mp3(wmix, audio_path, tm, reduce, interval, repeat,
                         loop_word)
            else:
                play_wav(wmix, audio_path, tm, reduce, interval, repeat,
                         loop_word)
            if join_queue:
                wmix.queue.on_play_count -= 1
    finally:
        if queue >= 0:
            wmix.queue.head += 1
        tm.close()
        wmix.thread_play -= 1


def _play_unsupported(wmix, path, kind):
    print(f"wmix-tpu: {kind} playback for {path} pending codec port")


def play_aac(wmix, aac_path: str, tm, reduce: int, interval: int,
             repeat: int, loop_word: int):
    """wmix_task_play_aac (src/wmixTask.c:1598-1806): frame-at-a-time
    aac_decode2 streamed into the mix ring with the mp3/wav pacing and
    repeat/interval discipline.  Geometry (chn/freq) comes from the
    decoder per frame, exactly as the C passes hInfo values into
    wmix_load_data."""
    from wmix_tpu_torch.codecs import aac as aacc
    try:
        f = open(aac_path, "rb")
    except OSError as e:
        print(f"wmix-tpu: aac open {aac_path} failed: {e}")
        return
    dec = None
    try:
        dec, raw, chn, freq = aacc.aac_decode2(dec, f)
    except aacc.AacError as e:
        print(f"wmix-tpu: aac decode {aac_path} failed: {e}")
        f.close()
        return
    if raw is None:
        print(f"wmix-tpu: aac_decode2 err")
        f.close()
        return

    reduce += 1
    reduce_skip = False
    if reduce > 1 and wmix.reduce_mode == 1:
        wmix.reduce_mode = reduce
        reduce_skip = True
    else:
        reduce = 1
    head, tick = 0, 0
    total_wait = wmix.cfg.frame_size * wmix.cfg.freq // 4
    try:
        while wmix.run and loop_word == wmix.loop_word:
            tm.poll()
            if raw:
                timeout = 0
                while (wmix.run and timeout < 200 and
                       loop_word == wmix.loop_word and
                       tick > wmix.tick and
                       tick - wmix.tick > total_wait):
                    timeout += 1
                    time.sleep(0.005)
                if not wmix.run or loop_word != wmix.loop_word:
                    return
                head, tick = wmix.load_data(raw, freq, chn, 16, head,
                                            reduce, tick)
                if head == 0:
                    return
            elif raw is not None:
                pass  # 0-byte frame (faad first-frame priming): continue
            elif interval > 0 or repeat > 0:
                if repeat > 0:
                    if repeat == 1:
                        return
                    repeat -= 1
                    if interval < 1:
                        interval = 1
                if reduce_skip and wmix.reduce_mode == reduce:
                    wmix.reduce_mode = 1
                f.seek(0)
                # the C keeps the decoder across the rewind: no
                # first-frame suppression on replay, and the filterbank
                # overlap carries over the loop seam — keep `dec`
                waited = 0
                while waited < interval * 1000:
                    time.sleep(0.1)
                    waited += 100
                    if not wmix.run or loop_word != wmix.loop_word:
                        return
                    tm.poll()
                if reduce_skip and wmix.reduce_mode == 1:
                    wmix.reduce_mode = reduce
                head, tick = wmix.head_off, 0
            else:
                return
            try:
                dec, raw, chn, freq = aacc.aac_decode2(dec, f)
            except aacc.AacError as e:
                print(f"wmix-tpu: aac decode error: {e}")
                return
    except _Killed:
        pass
    finally:
        f.close()
        if reduce_skip and wmix.reduce_mode == reduce:
            wmix.reduce_mode = 1


def play_mp3(wmix, mp3_path: str, tm, reduce: int, interval: int,
             repeat: int, loop_word: int):
    """wmix_task_play_mp3 (src/wmixTask.c:2022-2102): id3 skip + libmad
    decode (bit-exact codecs.mp3) streamed into the mix ring with the
    same pacing/repeat discipline as the wav player."""
    from wmix_tpu_torch.codecs import adts
    from wmix_tpu_torch.codecs import mp3 as mp3c
    try:
        with open(mp3_path, "rb") as f:
            data = f.read()
    except OSError as e:
        print(f"wmix-tpu: mp3 open {mp3_path} failed: {e}")
        return
    data = data[adts.id3_len(data):]

    reduce += 1
    reduce_skip = False
    if reduce > 1 and wmix.reduce_mode == 1:
        wmix.reduce_mode = reduce
        reduce_skip = True
    else:
        reduce = 1
    head, tick = 0, 0
    total_wait = wmix.cfg.frame_size * wmix.cfg.freq // 4
    try:
        while wmix.run and loop_word == wmix.loop_word:
            dec = mp3c.Mp3Decoder()
            played_any = False
            for pcm, freq, chn in dec.frames(bytes(data)):
                tm.poll()
                timeout = 0
                while (wmix.run and timeout < 200 and
                       loop_word == wmix.loop_word and
                       tick > wmix.tick and
                       tick - wmix.tick > total_wait):
                    timeout += 1
                    time.sleep(0.005)
                if not wmix.run or loop_word != wmix.loop_word:
                    return
                chunk = pcm.T.reshape(-1).tobytes()
                head, tick = wmix.load_data(chunk, freq, chn, 16, head,
                                            reduce, tick)
                played_any = True
                if head == 0:
                    return
            if not played_any:
                return
            if repeat > 0:
                if repeat == 1:
                    return
                repeat -= 1
                if interval < 1:
                    interval = 1
            if interval > 0:
                if reduce_skip and wmix.reduce_mode == reduce:
                    wmix.reduce_mode = 1
                waited = 0
                while waited < interval * 1000:
                    time.sleep(0.1)
                    waited += 100
                    if not wmix.run or loop_word != wmix.loop_word:
                        return
                    tm.poll()
                if reduce_skip and wmix.reduce_mode == 1:
                    wmix.reduce_mode = reduce
                head, tick = wmix.head_off, 0
            else:
                return
    except _Killed:
        pass
    finally:
        if reduce_skip and wmix.reduce_mode == reduce:
            wmix.reduce_mode = 1


def _play_pcm_stream(wmix, pcm: bytes, freq: int, chn: int, sample: int,
                     tm, reduce: int, interval: int, repeat: int,
                     loop_word: int):
    """Shared streaming body: chunked load_data with play-cursor pacing
    and the repeat/interval loop (mirrors wmix_task_play_wav)."""
    reduce += 1
    reduce_skip = False
    if reduce > 1 and wmix.reduce_mode == 1:
        wmix.reduce_mode = reduce
        reduce_skip = True
    else:
        reduce = 1
    bps = chn * sample // 8 * freq
    buff_size = bps
    buff_size2 = wmix.cfg.frame_size * wmix.cfg.freq
    if freq % 4 == 0:
        buff_size //= 4
        buff_size2 //= 4
        total_wait = buff_size2
    elif freq % 3 == 0:
        buff_size //= 3
        buff_size2 //= 3
        total_wait = buff_size2
    else:
        buff_size //= 2
        buff_size2 //= 2
        total_wait = buff_size2 // 2
    head, tick = 0, 0
    pos = 0
    interval_ms = interval * 1000
    try:
        while wmix.run and loop_word == wmix.loop_word:
            tm.poll()
            chunk = pcm[pos:pos + buff_size]
            pos += len(chunk)
            if chunk:
                timeout = 0
                while (wmix.run and timeout < 200 and
                       loop_word == wmix.loop_word and
                       tick > wmix.tick and
                       tick - wmix.tick > total_wait):
                    timeout += 1
                    time.sleep(0.005)
                if not wmix.run or loop_word != wmix.loop_word:
                    break
                head, tick = wmix.load_data(chunk, freq, chn, sample,
                                            head, reduce, tick)
                if head == 0:
                    break
            elif interval > 0 or repeat > 0:
                if repeat > 0:
                    if repeat == 1:
                        break
                    repeat -= 1
                    if interval < 1:
                        interval = 1
                        interval_ms = 1000
                if reduce_skip and wmix.reduce_mode == reduce:
                    wmix.reduce_mode = 1
                pos = 0
                waited = 0
                aborted = False
                while waited < interval_ms:
                    time.sleep(0.1)
                    waited += 100
                    if not wmix.run or loop_word != wmix.loop_word:
                        aborted = True
                        break
                    tm.poll()
                if aborted:
                    break
                if reduce_skip and wmix.reduce_mode == 1:
                    wmix.reduce_mode = reduce
                head, tick = wmix.head_off, 0
            else:
                break
    except _Killed:
        pass
    finally:
        if reduce_skip and wmix.reduce_mode == reduce:
            wmix.reduce_mode = 1


# ---------------------------------------------------------------------
# wav file player (wmix_task_play_wav, src/wmixTask.c:1353-1595)
# ---------------------------------------------------------------------

def play_wav(wmix, wav_path: str, tm: _TaskMsg, reduce: int,
             interval: int, repeat: int, loop_word: int):
    try:
        with open(wav_path, "rb") as f:
            data = f.read()
        hdr = wavc.WavHeader.unpack(data[:44])
    except (OSError, ValueError) as e:
        print(f"wmix-tpu: open {wav_path} failed: {e}")
        return
    pcm = data[44:]

    reduce += 1
    reduce_skip = False
    if reduce > 1 and wmix.reduce_mode == 1:
        wmix.reduce_mode = reduce
        reduce_skip = True
    else:
        reduce = 1

    bps = hdr.bytes_per_second
    buff_size = bps
    buff_size2 = wmix.cfg.frame_size * wmix.cfg.freq
    if hdr.sample_rate % 4 == 0:
        buff_size //= 4
        buff_size2 //= 4
        total_wait = buff_size2
    elif hdr.sample_rate % 3 == 0:
        buff_size //= 3
        buff_size2 //= 3
        total_wait = buff_size2
    else:
        buff_size //= 2
        buff_size2 //= 2
        total_wait = buff_size2 // 2

    head, tick = 0, 0
    pos = 0
    interval_ms = interval * 1000
    try:
        while wmix.run and loop_word == wmix.loop_word:
            tm.poll()
            chunk = pcm[pos:pos + buff_size]
            pos += len(chunk)
            if chunk:
                timeout = 0
                while (wmix.run and timeout < 200 and
                       loop_word == wmix.loop_word and
                       tick > wmix.tick and
                       tick - wmix.tick > total_wait):
                    timeout += 1
                    time.sleep(0.005)
                if not wmix.run or loop_word != wmix.loop_word:
                    break
                head, tick = wmix.load_data(chunk, hdr.sample_rate,
                                            hdr.channels, hdr.sample_bits,
                                            head, reduce, tick)
                if head == 0:
                    break
            elif interval > 0 or repeat > 0:
                if repeat > 0:
                    if repeat == 1:
                        break
                    repeat -= 1
                    if interval < 1:
                        interval = 1
                        interval_ms = 1000
                if reduce_skip and wmix.reduce_mode == reduce:
                    wmix.reduce_mode = 1
                pos = 0
                waited = 0
                aborted = False
                while waited < interval_ms:
                    time.sleep(0.1)
                    waited += 100
                    if not wmix.run or loop_word != wmix.loop_word:
                        aborted = True
                        break
                    tm.poll()
                if aborted:
                    break
                if reduce_skip and wmix.reduce_mode == 1:
                    wmix.reduce_mode = reduce
                head, tick = wmix.head_off, 0
            else:
                break
    except _Killed:
        pass
    finally:
        if reduce_skip and wmix.reduce_mode == reduce:
            wmix.reduce_mode = 1


# ---------------------------------------------------------------------
# FIFO stream tasks (src/wmixTask.c:20-309)
# ---------------------------------------------------------------------

def _parse_geometry(value: bytes):
    chn = value[0]
    sample = value[1]
    freq = (value[2] << 8) | value[3]
    return chn, sample, freq


def fifo_pcm_play(wmix, mtype: int, value: bytes):
    chn, sample, freq = _parse_geometry(value)
    path, _ = _split_cstr(value, 4)
    reduce = ((mtype >> 8) & 0xFF) + 1
    reduce_skip = False
    loop_word = wmix.loop_word_fifo

    try:
        os.mkfifo(path, 0o666)
    except FileExistsError:
        pass
    fd = os.open(path, os.O_RDONLY | os.O_NONBLOCK)

    if reduce > 1 and wmix.reduce_mode == 1:
        wmix.reduce_mode = reduce
        reduce_skip = True
    else:
        reduce = 1

    buff_size = chn * sample // 8 * freq
    head, tick = 0, 0
    wmix.thread_play += 1
    try:
        while wmix.run and loop_word == wmix.loop_word_fifo:
            try:
                chunk = os.read(fd, buff_size)
            except BlockingIOError:
                chunk = None
            if chunk:
                head, tick = wmix.load_data(chunk, freq, chn, sample,
                                            head, reduce, tick)
                if head == 0:
                    break
                continue
            time.sleep(0.005)
    finally:
        os.close(fd)
        if os.path.exists(path):
            os.remove(path)
        wmix.thread_play -= 1
        if reduce_skip:
            wmix.reduce_mode = 1


def _record_stream(wmix, value: bytes, loop_attr: str, encode=None,
                   pkg_mult: int = 10):
    """Shared body of fifo_pcm_record / fifo_g711a_record
    (src/wmixTask.c:122-309): shm origin ring -> zoom -> (encode) ->
    fifo."""
    chn, sample, freq = _parse_geometry(value)
    path, _ = _split_cstr(value, 4)
    loop_word = getattr(wmix, loop_attr)

    try:
        os.mkfifo(path, 0o666)
    except FileExistsError:
        pass
    fd = os.open(path, os.O_WRONLY)

    rd = MemReader(sysv.MEM_AI_ORIGIN_CHAR)
    buff_src = wmix.cfg.pkg_size * pkg_mult
    wmix.thread_record += 1
    try:
        while wmix.run and loop_word == getattr(wmix, loop_attr):
            got = rd.read(buff_src // 2, wait=False)
            if got.size:
                out = resample.pcm_zoom(wmix.cfg.chn, wmix.cfg.freq,
                                        got.tobytes(), chn, freq)
                if encode:
                    out = encode(out)
                try:
                    os.write(fd, out)
                except (BrokenPipeError, BlockingIOError):
                    break
            else:
                time.sleep(0.005)
    finally:
        os.close(fd)
        if os.path.exists(path):
            os.remove(path)
        wmix.thread_record -= 1


def fifo_pcm_record(wmix, mtype: int, value: bytes):
    _record_stream(wmix, value, "loop_word_fifo")


def fifo_g711a_record(wmix, mtype: int, value: bytes):
    _record_stream(
        wmix, value, "loop_word_fifo",
        encode=lambda pcm: g711.np_encode_alaw(
            np.frombuffer(pcm, np.int16)).tobytes())


# ---------------------------------------------------------------------
# wav recorder (wmix_thread_record_wav, src/wmixTask.c:410-505)
# ---------------------------------------------------------------------

def record_wav(wmix, mtype: int, value: bytes):
    chn, sample, freq = _parse_geometry(value)
    seconds = (value[4] << 8) | value[5]
    path, _ = _split_cstr(value, 6)
    loop_word = wmix.loop_word_record

    f = open(path, "wb")
    hdr = wavc.WavHeader.params(seconds, chn, sample, freq)
    f.write(hdr.pack())

    rd = MemReader(sysv.MEM_AI_ORIGIN_CHAR)
    sec_bytes = wmix.cfg.frame_size * wmix.cfg.freq
    buff_src = wmix.cfg.pkg_size * 5
    second = 0
    sec_count = 0
    wmix.thread_record += 1
    try:
        while wmix.run and loop_word == wmix.loop_word_record:
            got = rd.read(buff_src // 2, wait=False)
            if got.size:
                sec_count += got.size * 2
                if sec_count >= sec_bytes:
                    sec_count -= sec_bytes
                    second += 1
                out = resample.pcm_zoom(wmix.cfg.chn, wmix.cfg.freq,
                                        got.tobytes(), chn, freq)
                f.write(out)
                if second >= seconds:
                    break
            else:
                time.sleep(0.005)
    finally:
        wavc.write_len(f)
        f.close()
        wmix.thread_record -= 1


# ---------------------------------------------------------------------
# RTP PCMA tasks (src/wmixTask.c:1019-1351)
# ---------------------------------------------------------------------

def _parse_rtp(value: bytes):
    chn, sample, freq = _parse_geometry(value)
    port = (value[4] << 8) | value[5]
    bind_mode = bool(value[6])
    url, off = _split_cstr(value, 11)
    try:
        msg_path, _ = _split_cstr(value, off)
    except ValueError:
        msg_path = ""
    return chn, sample, freq, port, bind_mode, url, msg_path


def rtp_send_pcma(wmix, mtype: int, value: bytes):
    chn, sample, freq, port, bind_mode, url, msg_path = _parse_rtp(value)
    loop_word = wmix.loop_word_record
    try:
        ss = rtp.RtpSocket(url, port, bind_mode)
    except OSError as e:
        print(f"wmix-tpu: rtp_socket {url}:{port} err: {e}")
        return
    ss.header = rtp.RtpHeader(pt=rtp.PT_PCMA, m=1)
    tm = _TaskMsg(msg_path,
                  f"rtp send pcma, chn {chn}, freq {freq}, "
                  f"url {url}:{port}")
    rtp.create_sdp("/tmp/record.sdp", url, port, chn, freq, rtp.PT_PCMA)

    rd = MemReader(sysv.MEM_AI_ORIGIN_CHAR)
    buff_dist = wmix.cfg.interval_ms * freq // 1000 * chn * sample // 8
    buff_src = resample.len_of_in(wmix.cfg.chn, wmix.cfg.freq, chn, freq,
                                  buff_dist)
    ctrl = 0
    wmix.thread_record += 1
    try:
        while wmix.run and loop_word == wmix.loop_word_record:
            got = rd.read(buff_src // 2, wait=True, timeout=0.2)
            if got.size:
                pcm = got.tobytes()
                if ctrl == WCT_SILENCE:
                    pcm = bytes(len(pcm))
                out = resample.pcm_zoom(wmix.cfg.chn, wmix.cfg.freq, pcm,
                                        chn, freq)
                alaw = g711.np_encode_alaw(
                    np.frombuffer(out, np.int16)).tobytes()
                ss.header.timestamp = (ss.header.timestamp +
                                       len(alaw) // chn) & 0xFFFFFFFF
                if ss.send(alaw) < 0:
                    time.sleep(1.0)
                    ss.reconnect(url, port, bind_mode)
            c = tm.poll()
            if c == WCT_RESET:
                ss.reconnect(url, port, bind_mode)
                ctrl = WCT_CLEAR
            elif c == WCT_STOP:
                break
            elif c is not None:
                ctrl = c
    except _Killed:
        pass
    finally:
        ss.close()
        tm.close()
        wmix.thread_record -= 1


def rtp_recv_pcma(wmix, mtype: int, value: bytes):
    chn, sample, freq, port, bind_mode, url, msg_path = _parse_rtp(value)
    reduce = ((mtype >> 8) & 0xFF) + 1
    reduce_skip = False
    loop_word = wmix.loop_word_rtp
    try:
        ss = rtp.RtpSocket(url, port, bind_mode)
    except OSError as e:
        print(f"wmix-tpu: rtp_socket {url}:{port} err: {e}")
        return
    tm = _TaskMsg(msg_path,
                  f"rtp recv pcma, chn {chn}, freq {freq}, "
                  f"url {url}:{port}")

    if reduce > 1 and wmix.reduce_mode == 1:
        wmix.reduce_mode = reduce
        reduce_skip = True
    else:
        reduce = 1

    head, tick = 0, 0
    ctrl = 0
    recv_timeout = 0
    wmix.thread_play += 1
    try:
        while wmix.run and loop_word == wmix.loop_word_rtp:
            c = tm.poll()
            if c == WCT_RESET:
                ss.reconnect(url, port, bind_mode)
                ctrl = WCT_CLEAR
            elif c == WCT_STOP:
                break
            elif c is not None:
                ctrl = c
            got = ss.recv()
            if got is not None and got[2] > 0:
                _, payload, size = got
                pcm = g711.np_decode_alaw(
                    np.frombuffer(payload[:size], np.uint8)).tobytes()
                recv_timeout = 0
                if ctrl == WCT_SILENCE:
                    pcm = bytes(len(pcm))
                head, tick = wmix.load_data(pcm, freq, chn, sample, head,
                                            reduce, tick)
                continue
            recv_timeout += 5
            if recv_timeout >= 3000:
                time.sleep(1.0)
                ss.reconnect(url, port, bind_mode)
                recv_timeout = 0
                continue
            time.sleep(0.005)
    except _Killed:
        pass
    finally:
        ss.close()
        tm.close()
        wmix.thread_play -= 1
        if reduce_skip:
            wmix.reduce_mode = 1


# ---------------------------------------------------------------------
# AAC stream tasks (src/wmixTask.c:312-408, 538-631, 633-1016)
# ---------------------------------------------------------------------

def record_aac(wmix, mtype: int, value: bytes):
    """wmix_thread_record_aac (src/wmixTask.c:538-631): shm origin ->
    zoom to 1024-sample frames -> faac-equivalent encode -> ADTS file."""
    from wmix_tpu_torch.codecs import aacenc
    chn, sample, freq = _parse_geometry(value)
    seconds = (value[4] << 8) | value[5]
    path, _ = _split_cstr(value, 6)
    loop_word = wmix.loop_word_record

    try:
        f = open(path, "wb")
    except OSError as e:
        print(f"wmix-tpu: record-aac open {path} err: {e}")
        return
    rd = MemReader(sysv.MEM_AI_ORIGIN_CHAR)
    sec_bytes = wmix.cfg.frame_size * wmix.cfg.freq
    buff_dist = 1024 * chn * sample // 8
    buff_src = resample.len_of_in(wmix.cfg.chn, wmix.cfg.freq, chn, freq,
                                  buff_dist)
    enc = None
    second = 0
    sec_count = 0
    wmix.thread_record += 1
    try:
        while wmix.run and loop_word == wmix.loop_word_record:
            got = rd.read(buff_src // 2, wait=True, timeout=0.2)
            if not got.size:
                continue
            sec_count += got.size * 2
            if sec_count >= sec_bytes:
                sec_count -= sec_bytes
                second += 1
            out = resample.pcm_zoom(wmix.cfg.chn, wmix.cfg.freq,
                                    got.tobytes(), chn, freq)
            enc, blob = aacenc.aac_encode(enc, out, chn, freq)
            f.write(blob)
            if second >= seconds:
                break
    finally:
        f.close()
        wmix.thread_record -= 1


def fifo_aac_record(wmix, mtype: int, value: bytes):
    """wmix_thread_fifo_aac_record (src/wmixTask.c:312-408)."""
    from wmix_tpu_torch.codecs import aacenc
    chn, sample, freq = _parse_geometry(value)
    path, _ = _split_cstr(value, 4)
    loop_word = wmix.loop_word_fifo

    try:
        os.mkfifo(path, 0o666)
    except FileExistsError:
        pass
    fd = os.open(path, os.O_WRONLY)
    rd = MemReader(sysv.MEM_AI_ORIGIN_CHAR)
    buff_dist = 1024 * chn * sample // 8
    buff_src = resample.len_of_in(wmix.cfg.chn, wmix.cfg.freq, chn, freq,
                                  buff_dist)
    enc = None
    wmix.thread_record += 1
    try:
        while wmix.run and loop_word == wmix.loop_word_fifo:
            got = rd.read(buff_src // 2, wait=True, timeout=0.2)
            if not got.size:
                continue
            out = resample.pcm_zoom(wmix.cfg.chn, wmix.cfg.freq,
                                    got.tobytes(), chn, freq)
            enc, blob = aacenc.aac_encode(enc, out, chn, freq)
            if blob:
                try:
                    os.write(fd, blob)
                except (BrokenPipeError, BlockingIOError):
                    break
    finally:
        os.close(fd)
        if os.path.exists(path):
            os.remove(path)
        wmix.thread_record -= 1


def rtp_send_aac(wmix, mtype: int, value: bytes):
    """wmix_thread_rtp_send_aac (src/wmixTask.c:633-797): shm origin ->
    zoom -> encode -> strip the 7-byte ADTS header -> RTP AAC packets
    (timestamp advances by (buffer_fullness+1)/2, the reference quirk at
    :758-760 — fullness carries the encoder's code rate field)."""
    from wmix_tpu_torch.codecs import aacenc
    chn, sample, freq, port, bind_mode, url, msg_path = _parse_rtp(value)
    loop_word = wmix.loop_word_record
    try:
        ss = rtp.RtpSocket(url, port, bind_mode)
    except OSError as e:
        print(f"wmix-tpu: rtp_socket {url}:{port} err: {e}")
        return
    ss.header = rtp.RtpHeader(pt=rtp.PT_AAC, m=1, ssrc=0x32411)
    tm = _TaskMsg(msg_path,
                  f"rtp send aac, chn {chn}, freq {freq}, "
                  f"url {url}:{port}")
    rtp.create_sdp("/tmp/record-aac.sdp", url, port, chn, freq,
                   rtp.PT_AAC)

    rd = MemReader(sysv.MEM_AI_ORIGIN_CHAR)
    buff_dist = 1024 * chn * sample // 8
    buff_src = resample.len_of_in(wmix.cfg.chn, wmix.cfg.freq, chn, freq,
                                  buff_dist)
    enc = None
    ctrl = 0
    wmix.thread_record += 1
    try:
        while wmix.run and loop_word == wmix.loop_word_record:
            c = tm.poll()
            if c == WCT_RESET:
                ss.reconnect(url, port, bind_mode)
                ctrl = WCT_CLEAR
            elif c == WCT_STOP:
                break
            elif c is not None:
                ctrl = c
            got = rd.read(buff_src // 2, wait=True, timeout=0.2)
            if not got.size:
                continue
            pcm = got.tobytes()
            if ctrl == WCT_SILENCE:
                pcm = bytes(len(pcm))
            out = resample.pcm_zoom(wmix.cfg.chn, wmix.cfg.freq, pcm,
                                    chn, freq)
            enc, blob = aacenc.aac_encode(enc, out, chn, freq)
            if len(blob) > 7:
                # adts_buffer_fullness (faac writes 0x7FF): timestamp
                # advances by (fullness+1)/2 = 1024 per frame
                fullness = ((blob[5] & 0x1F) << 6) | (blob[6] >> 2)
                ss.header.timestamp = (ss.header.timestamp +
                                       (fullness + 1) // 2) & 0xFFFFFFFF
                if ss.send(blob[7:]) < 0:
                    time.sleep(1.0)
                    ss.reconnect(url, port, bind_mode)
                    break
    except _Killed:
        pass
    finally:
        ss.close()
        tm.close()
        wmix.thread_record -= 1


def rtp_recv_aac(wmix, mtype: int, value: bytes):
    """wmix_thread_rtp_recv_aac (src/wmixTask.c:799-1016): RTP AAC ->
    re-wrap with a synthesized ADTS header -> decode -> mix; the decoder
    renegotiates chn/freq at runtime from the decoded frames
    (:921-944)."""
    from wmix_tpu_torch.codecs import aac as aacc
    from wmix_tpu_torch.codecs import adts
    chn, sample, freq, port, bind_mode, url, msg_path = _parse_rtp(value)
    reduce = ((mtype >> 8) & 0xFF) + 1
    reduce_skip = False
    loop_word = wmix.loop_word_rtp
    try:
        ss = rtp.RtpSocket(url, port, bind_mode)
    except OSError as e:
        print(f"wmix-tpu: rtp_socket {url}:{port} err: {e}")
        return
    tm = _TaskMsg(msg_path,
                  f"rtp recv aac, chn {chn}, freq {freq}, "
                  f"url {url}:{port}")

    if reduce > 1 and wmix.reduce_mode == 1:
        wmix.reduce_mode = reduce
        reduce_skip = True
    else:
        reduce = 1

    dec = None
    head, tick = 0, 0
    ctrl = 0
    recv_timeout = 0
    wmix.thread_play += 1
    try:
        while wmix.run and loop_word == wmix.loop_word_rtp:
            c = tm.poll()
            if c == WCT_RESET:
                ss.reconnect(url, port, bind_mode)
                ctrl = WCT_CLEAR
            elif c == WCT_STOP:
                break
            elif c is not None:
                ctrl = c
            got = ss.recv()
            if got is not None and got[2] > 0:
                _, payload, size = got
                # payload[4:] skips the AU header (wmixTask.c:913 uses
                # &rtpPacket.payload[4])
                frame = adts.create_header(chn, freq, 0x7FF, size)[0] + \
                    payload[4:4 + size]
                try:
                    dec, raw, consumed, dchn, dfreq = aacc.aac_decode(
                        dec, frame)
                except aacc.AacError as e:
                    print(f"wmix-tpu: rtp aac_decode err: {e}")
                    raw = None
                recv_timeout = 0
                if raw:
                    if dchn and dfreq and (dchn != chn or dfreq != freq):
                        # runtime renegotiation (wmixTask.c:921-944)
                        chn, freq = dchn, dfreq
                        tm.describe(f"rtp recv aac, chn {chn}, "
                                    f"freq {freq}, url {url}:{port}")
                    pcm = raw
                    if ctrl == WCT_SILENCE:
                        pcm = bytes(len(pcm))
                    head, tick = wmix.load_data(pcm, freq, chn, sample,
                                                head, reduce, tick)
                continue
            recv_timeout += 5
            if recv_timeout >= 3000:
                time.sleep(1.0)
                ss.reconnect(url, port, bind_mode)
                recv_timeout = 0
                continue
            time.sleep(0.005)
    except _Killed:
        pass
    finally:
        ss.close()
        tm.close()
        wmix.thread_play -= 1
        if reduce_skip:
            wmix.reduce_mode = 1
