"""Emit mp3fe_tables.h for the native MP3 front-end (mp3fe.c) from the
repo's own generated constant module (wmix_tpu_torch/codecs/_mp3_tables.py).

Single-sourcing: the C front-end and the Python decoder share the exact
same numeric tables, so a drift between them is impossible.  Run
automatically by wmix_tpu_torch/codecs/mp3fe.py when the header is missing or
older than _mp3_tables.py.
"""
from __future__ import annotations

import os

import numpy as np


def _carr(name: str, vals, ctype: str = "int32_t") -> str:
    vals = [int(v) for v in np.asarray(vals).reshape(-1)]
    body = ",".join(str(v) for v in vals)
    return f"static const {ctype} {name}[{len(vals)}] = {{{body}}};\n"


def generate(out_path: str) -> None:
    from wmix_tpu_torch.codecs import _mp3_tables as T

    parts = ["/* GENERATED by gen_mp3fe_tables.py - do not edit. */\n",
             "#include <stdint.h>\n"]

    # huffman pair tables: flattened with per-table offset/len
    flat, offs, lens, linbits, startbits = [], [], [], [], []
    for tab, lb, sb in T.HUFF_PAIR:
        offs.append(len(flat))
        if tab is None:
            lens.append(0)
        else:
            flat.extend(int(v) for v in tab)
            lens.append(len(tab))
        linbits.append(lb)
        startbits.append(sb)
    parts.append(_carr("HUFF_PAIR_FLAT", flat, "uint16_t"))
    parts.append(_carr("HUFF_PAIR_OFF", offs))
    parts.append(_carr("HUFF_PAIR_LEN", lens))
    parts.append(_carr("HUFF_LINBITS", linbits))
    parts.append(_carr("HUFF_STARTBITS", startbits))
    qflat, qoffs = [], []
    for tab in T.HUFF_QUAD:
        qoffs.append(len(qflat))
        qflat.extend(int(v) for v in tab)
    parts.append(_carr("HUFF_QUAD_FLAT", qflat, "uint16_t"))
    parts.append(_carr("HUFF_QUAD_OFF", qoffs))

    parts.append(_carr("RQ_MANT", T.RQ_MANT))
    parts.append(_carr("RQ_EXP", T.RQ_EXP))
    parts.append(_carr("ROOT_TABLE", T.ROOT_TABLE))
    parts.append(_carr("SFLEN1", T.SFLEN1))
    parts.append(_carr("SFLEN2", T.SFLEN2))
    parts.append(_carr("NSFB_TABLE", np.asarray(T.NSFB)))  # [6][3][4]
    parts.append(_carr("PRETAB", T.PRETAB))
    parts.append(_carr("CS_TAB", T.CS))
    parts.append(_carr("CA_TAB", T.CA))
    parts.append(_carr("FASTSDCT_C", T.FASTSDCT_C))
    parts.append(_carr("SDCT_SCALE", T.SDCT_SCALE))
    parts.append(_carr("DCTIV_SCALE", T.DCTIV_SCALE))
    parts.append(_carr("WINDOW_L", T.WINDOW_L))
    parts.append(_carr("WINDOW_S", T.WINDOW_S))
    parts.append(_carr("IMDCT_S_TAB", T.IMDCT_S))
    parts.append(_carr("IS_TABLE", T.IS_TABLE))
    parts.append(_carr("IS_LSF_TABLE", T.IS_LSF_TABLE))

    # sfbwidth: [9 sfreqi][3 kinds][40 padded], plus the real lengths
    sw = np.zeros((9, 3, 40), np.int32)
    swlen = np.zeros((9, 3), np.int32)
    for i, row in enumerate(T.SFBWIDTH):
        for k, arr in enumerate(row):
            a = np.asarray(arr, np.int32)
            sw[i, k, :len(a)] = a
            swlen[i, k] = len(a)
    parts.append(_carr("SFBWIDTH_TAB", sw))
    parts.append(_carr("SFBWIDTH_LEN", swlen))

    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        f.write("".join(parts))
    os.replace(tmp, out_path)


if __name__ == "__main__":
    here = os.path.dirname(os.path.abspath(__file__))
    generate(os.path.join(here, "mp3fe_tables.h"))
    print("wrote mp3fe_tables.h")
