"""dct32: the 32-point fast DCT of the reference decoder's polyphase
synthesis (synth.c:126-505 — Lee's algorithm flow graph with the
OPT_SSO fixed-point arithmetic: MUL(a,b) = (a>>12)*(b>>16) in int32,
outputs rounded SHIFT(v) = (v + 2048) >> 12).

GENERATED from the flow graph by oracle/gen_mp3_tables.py tooling — the
statement list is the algorithm's SSA form; constants C[i] =
round(cos(pi*i/64) * 2^28) live in _mp3_tables.DCT32_COSTAB.

Vectorized: x may be [32] or [32, N] (leading axes after the 32 rows);
hi/lo outputs follow suit.  Framework-generic: numpy int32 arrays use
the numpy path; torch tensors run the identical int32 arithmetic (a
product of int32 tensors wraps as C's does, `>>` is arithmetic), so the
batched device synthesis (codecs/mp3_batch.py) shares this one SSA.
"""
import numpy as np

from wmix_tpu_torch.codecs import _mp3_tables as _T

I32 = np.int32
C = _T.DCT32_COSTAB
# Python-int halves of the MUL constants (b >> 16), exact in both
# frameworks; int32 wraparound is native to numpy and torch alike.
TWO = 2


def MUL(a, b):
    return (a >> 12) * int(I32(b) >> 16)


def SHIFT(v):
    return (v + 2048) >> 12


def dct32(x):
    """Returns (hi[16], lo[16]) stacked as two [16, ...] int32 arrays."""
    if isinstance(x, np.ndarray):
        x = np.asarray(x, I32)
        stack = lambda rows: np.array(rows, I32)
    else:
        import torch
        x = x.to(torch.int32)
        stack = lambda rows: torch.stack(rows)
    hi = [None] * 16
    lo = [None] * 16
    t0 = x[0] + x[31]
    t16 = MUL(x[0] - x[31], C[1])
    t1 = x[15] + x[16]
    t17 = MUL(x[15] - x[16], C[31])
    t41 = t16 + t17
    t59 = MUL(t16 - t17, C[2])
    t33 = t0 + t1
    t50 = MUL(t0 - t1, C[2])
    t2 = x[7] + x[24]
    t18 = MUL(x[7] - x[24], C[15])
    t3 = x[8] + x[23]
    t19 = MUL(x[8] - x[23], C[17])
    t42 = t18 + t19
    t60 = MUL(t18 - t19, C[30])
    t34 = t2 + t3
    t51 = MUL(t2 - t3, C[30])
    t4 = x[3] + x[28]
    t20 = MUL(x[3] - x[28], C[7])
    t5 = x[12] + x[19]
    t21 = MUL(x[12] - x[19], C[25])
    t43 = t20 + t21
    t61 = MUL(t20 - t21, C[14])
    t35 = t4 + t5
    t52 = MUL(t4 - t5, C[14])
    t6 = x[4] + x[27]
    t22 = MUL(x[4] - x[27], C[9])
    t7 = x[11] + x[20]
    t23 = MUL(x[11] - x[20], C[23])
    t44 = t22 + t23
    t62 = MUL(t22 - t23, C[18])
    t36 = t6 + t7
    t53 = MUL(t6 - t7, C[18])
    t8 = x[1] + x[30]
    t24 = MUL(x[1] - x[30], C[3])
    t9 = x[14] + x[17]
    t25 = MUL(x[14] - x[17], C[29])
    t45 = t24 + t25
    t63 = MUL(t24 - t25, C[6])
    t37 = t8 + t9
    t54 = MUL(t8 - t9, C[6])
    t10 = x[6] + x[25]
    t26 = MUL(x[6] - x[25], C[13])
    t11 = x[9] + x[22]
    t27 = MUL(x[9] - x[22], C[19])
    t46 = t26 + t27
    t64 = MUL(t26 - t27, C[26])
    t38 = t10 + t11
    t55 = MUL(t10 - t11, C[26])
    t12 = x[2] + x[29]
    t28 = MUL(x[2] - x[29], C[5])
    t13 = x[13] + x[18]
    t29 = MUL(x[13] - x[18], C[27])
    t47 = t28 + t29
    t65 = MUL(t28 - t29, C[10])
    t39 = t12 + t13
    t56 = MUL(t12 - t13, C[10])
    t14 = x[5] + x[26]
    t30 = MUL(x[5] - x[26], C[11])
    t15 = x[10] + x[21]
    t31 = MUL(x[10] - x[21], C[21])
    t48 = t30 + t31
    t66 = MUL(t30 - t31, C[22])
    t40 = t14 + t15
    t57 = MUL(t14 - t15, C[22])
    t69 = t33 + t34
    t89 = MUL(t33 - t34, C[4])
    t70 = t35 + t36
    t90 = MUL(t35 - t36, C[28])
    t71 = t37 + t38
    t91 = MUL(t37 - t38, C[12])
    t72 = t39 + t40
    t92 = MUL(t39 - t40, C[20])
    t73 = t41 + t42
    t94 = MUL(t41 - t42, C[4])
    t74 = t43 + t44
    t95 = MUL(t43 - t44, C[28])
    t75 = t45 + t46
    t96 = MUL(t45 - t46, C[12])
    t76 = t47 + t48
    t97 = MUL(t47 - t48, C[20])
    t78 = t50 + t51
    t100 = MUL(t50 - t51, C[4])
    t79 = t52 + t53
    t101 = MUL(t52 - t53, C[28])
    t80 = t54 + t55
    t102 = MUL(t54 - t55, C[12])
    t81 = t56 + t57
    t103 = MUL(t56 - t57, C[20])
    t83 = t59 + t60
    t106 = MUL(t59 - t60, C[4])
    t84 = t61 + t62
    t107 = MUL(t61 - t62, C[28])
    t85 = t63 + t64
    t108 = MUL(t63 - t64, C[12])
    t86 = t65 + t66
    t109 = MUL(t65 - t66, C[20])
    t113 = t69 + t70
    t114 = t71 + t72
    hi[15] = SHIFT(t113 + t114)
    lo[0] = SHIFT(MUL(t113 - t114, C[16]))
    t115 = t73 + t74
    t116 = t75 + t76
    t32 = t115 + t116
    hi[14] = SHIFT(t32)
    t118 = t78 + t79
    t119 = t80 + t81
    t58 = t118 + t119
    hi[13] = SHIFT(t58)
    t121 = t83 + t84
    t122 = t85 + t86
    t67 = t121 + t122
    t49 = (t67 * TWO) - t32
    hi[12] = SHIFT(t49)
    t125 = t89 + t90
    t126 = t91 + t92
    t93 = t125 + t126
    hi[11] = SHIFT(t93)
    t128 = t94 + t95
    t129 = t96 + t97
    t98 = t128 + t129
    t68 = (t98 * TWO) - t49
    hi[10] = SHIFT(t68)
    t132 = t100 + t101
    t133 = t102 + t103
    t104 = t132 + t133
    t82 = (t104 * TWO) - t58
    hi[9] = SHIFT(t82)
    t136 = t106 + t107
    t137 = t108 + t109
    t110 = t136 + t137
    t87 = (t110 * TWO) - t67
    t77 = (t87 * TWO) - t68
    hi[8] = SHIFT(t77)
    t141 = MUL(t69 - t70, C[8])
    t142 = MUL(t71 - t72, C[24])
    t143 = t141 + t142
    hi[7] = SHIFT(t143)
    lo[8] = SHIFT((MUL(t141 - t142, C[16]) * TWO) - t143)
    t144 = MUL(t73 - t74, C[8])
    t145 = MUL(t75 - t76, C[24])
    t146 = t144 + t145
    t88 = (t146 * TWO) - t77
    hi[6] = SHIFT(t88)
    t148 = MUL(t78 - t79, C[8])
    t149 = MUL(t80 - t81, C[24])
    t150 = t148 + t149
    t105 = (t150 * TWO) - t82
    hi[5] = SHIFT(t105)
    t152 = MUL(t83 - t84, C[8])
    t153 = MUL(t85 - t86, C[24])
    t154 = t152 + t153
    t111 = (t154 * TWO) - t87
    t99 = (t111 * TWO) - t88
    hi[4] = SHIFT(t99)
    t157 = MUL(t89 - t90, C[8])
    t158 = MUL(t91 - t92, C[24])
    t159 = t157 + t158
    t127 = (t159 * TWO) - t93
    hi[3] = SHIFT(t127)
    t160 = (MUL(t125 - t126, C[16]) * TWO) - t127
    lo[4] = SHIFT(t160)
    lo[12] = SHIFT((((MUL(t157 - t158, C[16]) * TWO) - t159) * TWO) - t160)
    t161 = MUL(t94 - t95, C[8])
    t162 = MUL(t96 - t97, C[24])
    t163 = t161 + t162
    t130 = (t163 * TWO) - t98
    t112 = (t130 * TWO) - t99
    hi[2] = SHIFT(t112)
    t164 = (MUL(t128 - t129, C[16]) * TWO) - t130
    t166 = MUL(t100 - t101, C[8])
    t167 = MUL(t102 - t103, C[24])
    t168 = t166 + t167
    t134 = (t168 * TWO) - t104
    t120 = (t134 * TWO) - t105
    hi[1] = SHIFT(t120)
    t135 = (MUL(t118 - t119, C[16]) * TWO) - t120
    lo[2] = SHIFT(t135)
    t169 = (MUL(t132 - t133, C[16]) * TWO) - t134
    t151 = (t169 * TWO) - t135
    lo[6] = SHIFT(t151)
    t170 = (((MUL(t148 - t149, C[16]) * TWO) - t150) * TWO) - t151
    lo[10] = SHIFT(t170)
    lo[14] = SHIFT((((((MUL(t166 - t167, C[16]) * TWO) - t168) * TWO) - t169) * TWO) - t170)
    t171 = MUL(t106 - t107, C[8])
    t172 = MUL(t108 - t109, C[24])
    t173 = t171 + t172
    t138 = (t173 * TWO) - t110
    t123 = (t138 * TWO) - t111
    t139 = (MUL(t121 - t122, C[16]) * TWO) - t123
    t117 = (t123 * TWO) - t112
    hi[0] = SHIFT(t117)
    t124 = (MUL(t115 - t116, C[16]) * TWO) - t117
    lo[1] = SHIFT(t124)
    t131 = (t139 * TWO) - t124
    lo[3] = SHIFT(t131)
    t140 = (t164 * TWO) - t131
    lo[5] = SHIFT(t140)
    t174 = (MUL(t136 - t137, C[16]) * TWO) - t138
    t155 = (t174 * TWO) - t139
    t147 = (t155 * TWO) - t140
    lo[7] = SHIFT(t147)
    t156 = (((MUL(t144 - t145, C[16]) * TWO) - t146) * TWO) - t147
    lo[9] = SHIFT(t156)
    t175 = (((MUL(t152 - t153, C[16]) * TWO) - t154) * TWO) - t155
    t165 = (t175 * TWO) - t156
    lo[11] = SHIFT(t165)
    t176 = (((((MUL(t161 - t162, C[16]) * TWO) - t163) * TWO) - t164) * TWO) - t165
    lo[13] = SHIFT(t176)
    lo[15] = SHIFT((((((((MUL(t171 - t172, C[16]) * TWO) - t173) * TWO) - t174) * TWO) - t175) * TWO) - t176)
    return stack(hi), stack(lo)
