"""Codec configuration (no torch; a copy of the JAX package's ``core/config.py``).

The reference keeps every format parameter as a compile-time constant
(`llcomp.hpp:18-25`).  Here they live in a frozen dataclass; the default
instance is pinned to the rev-2 values required for bit-exactness against the
C++ encoder/decoder.  Every configuration that ``check`` passes is coded:
the kernels are built once a configuration (``defines``), and the plain
versions read the same contexts (``exp_ctx``, ``mant_ctx``).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Format parameters of an llcomp bitstream revision.

    Defaults reproduce rev 2 (`llcomp.hpp:19-25`):  magic byte ``0x77 + revision``,
    LargeModel 5-neighbor context hash, exponent-context cap 4, mantissa-context
    cap 6, sign context 7, and 8 adaptive sub-states per context hash.
    """

    revision: int = 2
    large_model: bool = True
    e_lim: int = 4      # exponent context saturates at this value (contexts 1..4)
    r_lim: int = 6      # mantissa context saturates here      (contexts 5..6)
    sign_ctx: int = 7   # sign bit context                      (context  7)
    substates: int = 8  # sub-states per context hash (0..7 above)

    # Fixed-shape decomposition bound: a symbol's |diff| <= 1274 (post-RCT values
    # span [-255, 382], the gradient predictor spans [-892, 1019]), so the
    # exponent e <= 10 and a symbol emits at most 2e + 3 = 23 binary decisions.
    max_bins_per_symbol: int = 24

    @property
    def magic(self) -> int:
        return (0x77 + self.revision) & 0xFF

    @property
    def num_hashes(self) -> int:
        """Reachable context hashes after sign folding.

        The reference allocates ``(11*11*11*5*5 + 1) / 2`` hash slots
        (`llcomp.hpp:26-32`) but only hashes 0..7925 are reachable
        (max = 5 + 5*11 + 5*121 + 2*605 + 2*3025 = 7925); the trimmed model is
        bit-exact-equivalent.
        """
        if self.large_model:
            return 5 + 5 * 11 + 5 * 121 + 2 * 605 + 2 * 3025 + 1  # 7926
        return 5 + 5 * 11 + 5 * 121 + 1  # 666

    @property
    def num_states(self) -> int:
        """Size of the (trimmed) adaptive model in bytes: one u8 per sub-state."""
        return self.num_hashes * self.substates


#: The one configuration that is bit-exact against the reference bitstream.
REV2 = CodecConfig()

#: File extension of the single-stream reference-compatible format.
EXT = ".llcomp"
#: File extension of the sliced multi-stream container (this framework's own).
EXT_SLICED = ".llct"


#: Largest exponent of a residual: |diff| <= 1274, so e = floor(log2 |diff|)
#: <= 10 and a symbol takes at most 2 * 10 + 3 decisions.
MAX_EXP = 10
MIN_BINS = 2 * MAX_EXP + 3
#: Start tables (the static prior, the stored seed) hold this many substates
#: a bucket.
TABLE_SUBSTATES = 8


def exp_ctx(cfg: CodecConfig, k: int) -> int:
    """Context of a symbol's exponent decision k (k = 1 .. e + 1: e ones,
    then the stop)."""
    return min(k, cfg.e_lim)


def mant_ctx(cfg: CodecConfig, j: int) -> int:
    """Context of a symbol's mantissa decision j (j = 0 .. e - 1, most
    significant bit first)."""
    return min(cfg.e_lim + 1 + j, cfg.r_lim)


def contexts(cfg: CodecConfig) -> dict[str, list[int]]:
    """The contexts binarization can give, by the field that sets them:
    the zero flag 0, ``exp_ctx`` for k = 1 .. 11, ``mant_ctx`` for j =
    0 .. 9 and ``sign_ctx``."""
    return {"zero flag": [0],
            "e_lim": [exp_ctx(cfg, k) for k in range(1, MAX_EXP + 2)],
            "r_lim": [mant_ctx(cfg, j) for j in range(MAX_EXP)],
            "sign_ctx": [cfg.sign_ctx]}


def check(cfg: CodecConfig) -> None:
    """Raise ValueError, naming the field, for a configuration the codec
    cannot code: a revision outside 1-255 (the magic byte and the
    container's revision byte must hold it, and must not be revision 0's
    0x77), fewer than one substate, a context outside ``[0, substates)``
    (``contexts``), or fewer than ``MIN_BINS`` decisions a symbol."""
    if not isinstance(cfg, CodecConfig):
        raise TypeError(f"cfg must be a CodecConfig, got {type(cfg).__name__}")
    if not 1 <= cfg.revision <= 255:
        raise ValueError(f"revision {cfg.revision} is outside 1-255")
    if cfg.substates < 1:
        raise ValueError(f"substates {cfg.substates} is below 1")
    for field, ctxs in contexts(cfg).items():
        bad = sorted({c for c in ctxs if not 0 <= c < cfg.substates})
        if bad:
            raise ValueError(f"{field} gives contexts {bad}, outside "
                             f"[0, substates={cfg.substates})")
    if cfg.max_bins_per_symbol < MIN_BINS:
        raise ValueError(f"max_bins_per_symbol {cfg.max_bins_per_symbol} is "
                         f"below {MIN_BINS}, the decisions of |diff| 1274")


def check_start(cfg: CodecConfig, table: bool) -> None:
    """Raise ValueError where a start table (primed, or a stored seed) is
    asked for under a cfg whose substates are not the tables' 8 a bucket."""
    if table and cfg.substates != TABLE_SUBSTATES:
        raise ValueError(f"primed and seeded starts need substates == 8 "
                         f"(the prior's and the seed's rows), not "
                         f"substates={cfg.substates}")


# The -D define of each field that the kernels read (csrc/encode_fused.cu,
# csrc/decode_kernel.cu); REV2's values are the kernels' defaults.
_DEFINES = {"e_lim": "LLCT_E_LIM", "r_lim": "LLCT_R_LIM",
            "sign_ctx": "LLCT_SIGN_CTX", "substates": "LLCT_SUBSTATES",
            "large_model": "LLCT_LARGE_MODEL", "num_hashes": "LLCT_NUM_HASHES",
            "max_bins_per_symbol": "LLCT_MAX_BINS"}


def defines(cfg: CodecConfig) -> tuple[str, ...]:
    """The compiler defines of ``cfg``'s kernel build: one ``-D`` a field
    that differs from REV2's, so that REV2 (and a cfg that differs from it
    only in ``revision``) builds with none, as the default kernel."""
    check(cfg)
    return tuple(f"-D{name}={int(getattr(cfg, field))}"
                 for field, name in _DEFINES.items()
                 if getattr(cfg, field) != getattr(REV2, field))


def model_words(cfg: CodecConfig) -> int:
    """64-bit words of a lane's model in the kernels: ceil(substates / 8)
    words a context hash, rounded up to an even count (the start fill
    stores 16 bytes at a time)."""
    words = cfg.num_hashes * -(-cfg.substates // 8)
    return words + words % 2
