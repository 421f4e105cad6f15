"""Emit aacfe_tables.h for the native AAC-LC front-end (aacfe.c) from
the repo's own generated constant module (codecs/_aac_tables.py).

Float tables are emitted as uint32 bit patterns inside unions so the C
side reads the EXACT same binary32 values the Python front-end uses.
Run automatically by wmix_tpu_torch/codecs/aacfe.py when the header is stale.
"""
from __future__ import annotations

import os

import numpy as np


def _iarr(name: str, vals, ctype: str = "int32_t") -> str:
    vals = [int(v) for v in np.asarray(vals).reshape(-1)]
    body = ",".join(str(v) for v in vals)
    return f"static const {ctype} {name}[{len(vals)}] = {{{body}}};\n"


def _farr(name: str, vals) -> str:
    bits = np.asarray(vals, np.float32).reshape(-1).view(np.uint32)
    body = ",".join(f"0x{v:08x}" for v in bits)
    return (f"static const union {{ uint32_t u[{bits.size}]; "
            f"float f[{bits.size}]; }} {name} = {{.u = {{{body}}}}};\n")


def generate(out_path: str) -> None:
    from wmix_tpu_torch.codecs import _aac_tables as T
    from wmix_tpu_torch.codecs import aac as A

    parts = ["/* GENERATED by gen_aacfe_tables.py - do not edit. */\n",
             "#include <stdint.h>\n"]

    # scalefactor binary tree [241][2]
    parts.append(_iarr("HCB_SF", T.HCB_SF))

    # 2-step tables: firsts [N][2] and seconds [M][5 or 3], flattened
    # with per-codebook offsets.  Codebook index 0..11; unused books get
    # len 0.  kind: 0 = none, 1 = 2step quad, 2 = 2step pair,
    # 3 = binary quad, 4 = binary pair.
    first_flat, first_off = [], []
    sec_flat, sec_off = [], []
    kind = [0] * 12
    hcb_n = [0] * 12
    width = [0] * 12
    twostep = {1: (T.HCB1_1, T.HCB1_2Q, 1, 4), 2: (T.HCB2_1, T.HCB2_2Q, 1, 4),
               4: (T.HCB4_1, T.HCB4_2Q, 1, 4), 6: (T.HCB6_1, T.HCB6_2P, 2, 2),
               8: (T.HCB8_1, T.HCB8_2P, 2, 2),
               10: (T.HCB10_1, T.HCB10_2P, 2, 2),
               11: (T.HCB11_1, T.HCB11_2P, 2, 2)}
    binary = {3: (T.HCB3_BINQ, 3, 4), 5: (T.HCB5_BINP, 4, 2),
              7: (T.HCB7_BINP, 4, 2), 9: (T.HCB9_BINP, 4, 2)}
    for cb in range(12):
        first_off.append(len(first_flat) // 2)
        sec_off.append(len(sec_flat))
        if cb in twostep:
            f1, f2, k, w = twostep[cb]
            kind[cb] = k
            width[cb] = w
            hcb_n[cb] = A.T.HCB_N[cb]
            first_flat.extend(int(v) for v in np.asarray(f1).reshape(-1))
            # seconds padded to 5 columns
            f2a = np.asarray(f2)
            pad = np.zeros((f2a.shape[0], 5), np.int64)
            pad[:, :f2a.shape[1]] = f2a
            sec_flat.extend(int(v) for v in pad.reshape(-1))
        elif cb in binary:
            f2, k, w = binary[cb]
            kind[cb] = k
            width[cb] = w
            f2a = np.asarray(f2)
            pad = np.zeros((f2a.shape[0], 5), np.int64)
            pad[:, :f2a.shape[1]] = f2a
            sec_flat.extend(int(v) for v in pad.reshape(-1))
    parts.append(_iarr("HCB_FIRST_FLAT", first_flat, "int16_t"))
    parts.append(_iarr("HCB_FIRST_OFF", first_off))
    parts.append(_iarr("HCB_SEC_FLAT", sec_flat, "int16_t"))
    parts.append(_iarr("HCB_SEC_OFF", sec_off))
    parts.append(_iarr("HCB_KIND", kind))
    parts.append(_iarr("HCB_NBITS", hcb_n))
    parts.append(_iarr("HCB_WIDTH", width))

    parts.append(_farr("IQ_TABLE", T.IQ_TABLE))
    parts.append(_farr("POW2SF_TAB", T.POW2SF_TAB))
    parts.append(_farr("POW2_TABLE", T.POW2_TABLE))
    parts.append(_farr("TNS_COEF_0_3", T.TNS_COEF_0_3))
    parts.append(_farr("TNS_COEF_0_4", T.TNS_COEF_0_4))
    parts.append(_farr("TNS_COEF_1_3", T.TNS_COEF_1_3))
    parts.append(_farr("TNS_COEF_1_4", T.TNS_COEF_1_4))

    parts.append(_iarr("NUM_SWB_1024_WINDOW", T.NUM_SWB_1024_WINDOW))
    parts.append(_iarr("NUM_SWB_128_WINDOW", T.NUM_SWB_128_WINDOW))
    # swb offsets per sf_index, padded [12][64]
    for nm, lst in (("SWB_1024_TAB", A.SWB_1024),
                    ("SWB_128_TAB", A.SWB_128)):
        tab = np.zeros((12, 64), np.int32)
        for i, arr in enumerate(lst):
            a = np.asarray(arr, np.int32)
            tab[i, :len(a)] = a
        parts.append(_iarr(nm, tab))
    parts.append(_iarr("SAMPLE_RATES_TAB", A.SAMPLE_RATES))
    parts.append(_iarr("TNS_SBF_MAX_TAB", np.asarray(A.TNS_SBF_MAX)))

    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        f.write("".join(parts))
    os.replace(tmp, out_path)


if __name__ == "__main__":
    here = os.path.dirname(os.path.abspath(__file__))
    generate(os.path.join(here, "aacfe_tables.h"))
    print("wrote aacfe_tables.h")
