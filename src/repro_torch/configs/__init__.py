"""Per-architecture configs (assigned pool) + the shape registry: the
port's copy of ``repro.configs``, registering the same ten names."""
from .base import (ALL_SHAPES, ArchConfig, MoESpec, ShapeSpec, all_archs,
                   get_arch, reduced_for_smoke, register, shapes_for,
                   skipped_shapes_for, TRAIN_4K, PREFILL_32K, DECODE_32K,
                   LONG_500K)

__all__ = ["ALL_SHAPES", "ArchConfig", "MoESpec", "ShapeSpec", "all_archs",
           "get_arch", "reduced_for_smoke", "register", "shapes_for",
           "skipped_shapes_for", "TRAIN_4K", "PREFILL_32K", "DECODE_32K",
           "LONG_500K"]
