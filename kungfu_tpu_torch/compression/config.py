"""CompressionConfig + the named-strategy registry (counterpart of
kungfu_tpu.compression.config, with the same names, presets and errors).

The reference treats the communication *route* as a tunable (strategy enum,
plan/strategy.py); this module makes the communication *representation* a
tunable of the same rank.  A `CompressionConfig` is a frozen, hashable value
object, so a config can key a cache the way a strategy does: "switch
bit-width" means "take the other path", exactly like a strategy swap.

Named registry: configs register under short names ("int8", "fp8", ...) so
CLI flags, env vars and JSON benchmark specs can select them; `resolve`
accepts a config, a registered name, or None (= no compression).

Per-axis selection: the optimizer/FSDP wrappers accept either one config
(applied to the whole reduction) or a `{axis_name: config}` dict — the
EQuARX-motivated deployment shape is `{"ici": None, "dcn": INT8}`: full
precision on the fast intra-slice fabric, quantized on the slow DCN hop.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Union

#: fp8 e4m3 finite max (used as the fp8 per-block scale target)
FP8_E4M3_MAX = 448.0

#: int8 symmetric code range
INT8_MAX = 127


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """One compression strategy for collective payloads.

    Attributes:
      scheme: "none" | "bf16" | "int8" | "fp8" | "topk" | "randk".
        none/bf16/int8/fp8 are dense wire formats usable for allreduce;
        topk/randk are sparsifiers for the gossip pair-exchange path.
      block: elements per quantization block (one f32 scale per block).
        Smaller blocks track local dynamic range (tighter error) at higher
        scale overhead: 4/block extra bytes per block.
      stochastic: unbiased stochastic rounding (int8 only).  Costs one
        uniform sample per element; makes E[dequant(quant(x))] == x, the
        property EF-free convergence proofs want.
      k: kept fraction for topk/randk sparsifiers (0 < k <= 1).
      error_feedback: whether optimizer wrappers should keep an EF residual
        for this config (plain functional collectives ignore it).
    """

    scheme: str = "none"
    block: int = 256
    stochastic: bool = False
    k: float = 0.01
    error_feedback: bool = True

    def __post_init__(self):
        if self.scheme not in ("none", "bf16", "int8", "fp8", "topk", "randk"):
            raise ValueError(f"unknown compression scheme {self.scheme!r}")
        if self.block <= 0:
            raise ValueError(f"block must be positive, got {self.block}")
        if not (0.0 < self.k <= 1.0):
            raise ValueError(f"sparsifier fraction k must be in (0, 1], got {self.k}")

    # -- wire accounting ----------------------------------------------------------------

    @property
    def is_quantized(self) -> bool:
        return self.scheme in ("int8", "fp8")

    @property
    def is_sparse(self) -> bool:
        return self.scheme in ("topk", "randk")

    def wire_bytes(self, n_elements: int, itemsize: int = 4) -> int:
        """Bytes one peer puts on the wire per collective leg for a tensor
        of `n_elements` (uncompressed element width `itemsize`)."""
        if self.scheme == "none":
            return n_elements * itemsize
        if self.scheme == "bf16":
            return n_elements * 2
        if self.is_quantized:
            nblocks = math.ceil(n_elements / self.block)
            return n_elements * 1 + nblocks * 4  # codes + one f32 scale/block
        # sparse: (value f32, index int32) per kept element
        kept = max(1, int(round(self.k * n_elements)))
        return kept * (4 + 4)

    def describe(self) -> str:
        if self.scheme == "none":
            return "none"
        if self.scheme == "bf16":
            return "bf16"
        if self.is_quantized:
            sr = "+sr" if self.stochastic else ""
            return f"{self.scheme}(block={self.block}{sr})"
        return f"{self.scheme}(k={self.k})"


AxisCompression = Union[
    None, str, CompressionConfig, Mapping[str, Union[None, str, CompressionConfig]]
]


@dataclasses.dataclass(frozen=True)
class AxisConfig:
    """Frozen per-axis wire-format selection — the *installable* form of the
    `{axis: config}` mapping.  Unlike a dict it is hashable, so it can key a
    cache exactly like a single CompressionConfig.
    """

    legs: tuple = ()  # ((axis_name, CompressionConfig), ...) sorted by axis

    @classmethod
    def make(cls, mapping: Mapping) -> "AxisConfig":
        return cls(legs=tuple(sorted(
            (str(k), resolve(v)) for k, v in dict(mapping).items()
        )))

    def get(self, axis: str) -> CompressionConfig:
        for k, c in self.legs:
            if k == axis:
                return c
        return NONE

    @property
    def is_compressed(self) -> bool:
        return any(c.scheme != "none" for _, c in self.legs)

    def describe(self) -> str:
        return ",".join(f"{k}={c.describe()}" for k, c in self.legs) or "none"


_REGISTRY: Dict[str, CompressionConfig] = {}


def register(name: str, cfg: CompressionConfig) -> CompressionConfig:
    """Register a named config (overwrites: latest wins, like strategy
    re-installation in the reference's adaptation path)."""
    _REGISTRY[name.lower()] = cfg
    return cfg


def registered() -> Dict[str, CompressionConfig]:
    return dict(_REGISTRY)


def resolve(cfg: Union[None, str, CompressionConfig]) -> CompressionConfig:
    """Config | registered name | None -> CompressionConfig."""
    if cfg is None:
        return NONE
    if isinstance(cfg, CompressionConfig):
        return cfg
    if isinstance(cfg, str):
        try:
            return _REGISTRY[cfg.lower()]
        except KeyError:
            raise ValueError(
                f"unknown compression {cfg!r}; registered: {sorted(_REGISTRY)}"
            ) from None
    raise TypeError(f"cannot resolve compression config from {type(cfg).__name__}")


def validate_axis_keys(
    cfg: AxisCompression, known_axes, context: str = ""
) -> None:
    """Eagerly reject per-axis keys that name no known mesh axis.

    A typo'd key ({"dcn ": "int8"} vs {"dcn": "int8"}) is otherwise
    *silent*: resolve_for_axis's dict .get() misses and the axis quietly
    stays full precision — the deployment thinks it is compressing the DCN
    hop and isn't.  Call this wherever the axis set is known (the optimizer
    wrappers do, at construction).
    """
    if not isinstance(cfg, Mapping):
        return
    known = tuple(known_axes)
    bad = sorted(k for k in cfg if k not in known)
    if bad:
        where = f" ({context})" if context else ""
        raise ValueError(
            f"compression config keys {bad} name no known axis{where}; "
            f"known axes: {sorted(known)} — a typo'd axis key silently "
            "falls back to full precision"
        )


def resolve_for_axis(
    cfg: AxisCompression, axis_name, known_axes=None
) -> CompressionConfig:
    """Per-axis lookup: dicts map axis name -> config (missing = none).

    `known_axes`, when given, validates dict keys eagerly (see
    validate_axis_keys) before the lookup.
    """
    if isinstance(cfg, Mapping):
        if known_axes is not None:
            validate_axis_keys(cfg, known_axes)
        return resolve(cfg.get(axis_name))
    return resolve(cfg)


# -- built-in presets -------------------------------------------------------------------

NONE = register("none", CompressionConfig(scheme="none"))
BF16 = register("bf16", CompressionConfig(scheme="bf16"))
INT8 = register("int8", CompressionConfig(scheme="int8"))
INT8_SR = register("int8-sr", CompressionConfig(scheme="int8", stochastic=True))
FP8 = register("fp8", CompressionConfig(scheme="fp8"))
TOPK_1PCT = register("topk", CompressionConfig(scheme="topk", k=0.01))
RANDK_1PCT = register("randk", CompressionConfig(scheme="randk", k=0.01))
