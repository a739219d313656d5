"""The port's logical-axis sharding (``repro_torch.distributed.sharding``)
against the reference's (``repro.distributed.sharding``).

* The reference's ``tests/test_sharding.py`` cases, ported (meshes as
  {axis: size} mappings, which the port's resolution takes beside a
  ``DeviceMesh``).
* For all 11 archs at their full configs, ``param_axes()`` and
  ``decode_state_axes()`` equal the reference's leaf for leaf.
* For every parameter, optimizer and decode-state leaf of every arch, under
  all three rule sets, on the production mesh shapes (16, 16), (32, 8),
  (2, 16, 16) and (2, 32, 8), ``partition_spec_for`` equals the
  reference's on a ``jax.sharding.AbstractMesh`` (no devices), and
  ``bytes_per_device`` equals the bytes of the reference's
  ``NamedSharding.shard_shape`` of every leaf.  (The reference's own
  ``bytes_per_device`` divides by the mesh's device count whatever the spec
  and cannot run on an abstract mesh.)
* A property test of the resolution: no mesh axis used twice in one
  tensor, every sharded dimension divisible by its axes' size.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec

from repro.configs import ARCH_IDS
from repro.configs import get_arch as ref_get_arch
from repro.distributed import sharding as ref
from repro.models.transformer import TransformerLM as RefLM
from repro_torch.configs import get_arch
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import (
    DECODE_RULES,
    LONG_CONTEXT_RULES,
    TRAIN_RULES,
    bytes_per_device,
    partition_spec_for,
    placements_for,
    rules_for_shape,
    shard_shape,
    tree_leaves_axes,
)
from repro_torch.models.transformer import DecodeState, TransformerLM
from repro_torch.optim.adamw import AdamW
from repro_torch.pytree import tree_leaves
from repro_torch.train.step import train_state_axes, train_state_shapes

MESHES = {
    "16x16": {"data": 16, "model": 16},
    "32x8": {"data": 32, "model": 8},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "2x32x8": {"pod": 2, "data": 32, "model": 8},
}
RULES = {"train": (TRAIN_RULES, ref.TRAIN_RULES), "decode": (DECODE_RULES, ref.DECODE_RULES),
         "long_context": (LONG_CONTEXT_RULES, ref.LONG_CONTEXT_RULES)}


def _abstract(sizes):
    return AbstractMesh(tuple(sizes.values()), tuple(sizes))


def _as_tuple(spec: PartitionSpec):
    """The reference's PartitionSpec in the port's form."""
    return tuple(spec)


# ---------------------------------------------------------------------------
# tests/test_sharding.py, ported
# ---------------------------------------------------------------------------


def test_ffn_shards_over_model():
    spec = partition_spec_for(("embed", "ffn"), (128, 256), {"data": 1, "model": 1},
                              TRAIN_RULES)
    assert spec == ()  # size-1 axes are never assigned


def test_divisibility_fallback_heads_to_head_dim():
    """hymba: 25 q heads don't divide a 16-way model axis; head_dim (64)
    does — TP survives via the fallback chain."""
    spec = partition_spec_for(("embed", "q_heads", "head_dim"), (1600, 25, 64),
                              {"data": 1, "model": 16}, TRAIN_RULES)
    assert spec == (None, None, "model")


def test_batch_uses_pod_and_data_axes():
    spec = partition_spec_for(("batch", "seq"), (8, 128), {"pod": 2, "data": 2, "model": 2},
                              TRAIN_RULES)
    assert spec == (("pod", "data"),)
    assert placements_for(spec, {"pod": 2, "data": 2, "model": 2}) == (
        torch.distributed.tensor.Shard(0), torch.distributed.tensor.Shard(0),
        torch.distributed.tensor.Replicate())


def test_long_context_rules_shard_kv_seq_not_batch():
    rules = rules_for_shape("decode", global_batch=1)
    assert rules is LONG_CONTEXT_RULES
    spec = partition_spec_for(("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
                              (4, 1, 1024, 2, 64), {"data": 4, "model": 1}, rules)
    assigned = spec[2] if len(spec) > 2 else None
    assert assigned is not None
    names = (assigned,) if isinstance(assigned, str) else assigned
    assert "data" in names
    assert len(spec) < 2 or spec[1] is None


def test_no_mesh_axis_reused_within_tensor():
    spec = partition_spec_for(("experts", "embed", "ffn"), (4, 64, 128),
                              {"data": 2, "model": 2}, TRAIN_RULES)
    # experts takes model; embed takes data; ffn wants model (taken) -> None
    assert spec == ("model", "data")


def test_rule_tables_equal_the_reference():
    for port, reference in RULES.values():
        assert port.name == reference.name
        assert port.rules == reference.rules
    for kind, b in (("train", 256), ("prefill", 32), ("decode", 128), ("decode", 1)):
        assert rules_for_shape(kind, b).name == ref.rules_for_shape(kind, b).name
    for kind in ("train", "prefill", "decode"):
        assert sharding.input_sharding_axes(kind) == ref.input_sharding_axes(kind)


# ---------------------------------------------------------------------------
# Logical axes of every arch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_axes_equal_reference(arch):
    assert TransformerLM(get_arch(arch).config).param_axes() == \
        RefLM(ref_get_arch(arch).config).param_axes()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_state_axes_equal_reference(arch):
    got = TransformerLM(get_arch(arch).config).decode_state_axes()
    want = RefLM(ref_get_arch(arch).config).decode_state_axes()
    assert (got.kv, got.ssm, got.cross_kv, got.length) == \
        (want.kv, want.ssm, want.cross_kv, want.length)


def _decode_state_shapes(cfg, batch, max_len):
    """The decode state's leaves as meta tensors (init_decode_state's)."""
    def meta(*shape, dtype=cfg.dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    kv = ssm = cross = None
    if cfg.uses_attention:
        kv = {n: meta(cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
              for n in ("k", "v")}
    if cfg.uses_ssm:
        d = cfg.ssm_dims
        ssm = {"h": meta(cfg.n_layers, batch, d["n_heads"], d["head_dim"], d["d_state"],
                         dtype=torch.float32),
               "conv": meta(cfg.n_layers, batch, d["d_conv"] - 1, d["conv_dim"])}
    if cfg.n_encoder_layers:
        cross = {n: meta(cfg.n_layers, batch, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim)
                 for n in ("k", "v")}
    return DecodeState(kv=kv, ssm=ssm, cross_kv=cross,
                       length=meta(batch, dtype=torch.int32))


def _leaves(arch):
    """(train-state leaves and axes, decode-state leaves and axes) at the
    full config (decode_32k's batch and length)."""
    cfg = get_arch(arch).config
    model, opt = TransformerLM(cfg), AdamW()
    train = (tree_leaves(train_state_shapes(model, opt)),
             tree_leaves_axes(train_state_axes(model, opt)))
    decode = (tree_leaves(_decode_state_shapes(cfg, 128, 32768)),
              tree_leaves_axes(model.decode_state_axes()))
    for leaves, axes in (train, decode):
        assert len(leaves) == len(axes)
    return train, decode


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_partition_specs_and_bytes_equal_reference(arch, mesh_name):
    sizes = MESHES[mesh_name]
    amesh = _abstract(sizes)
    for leaves, axes in _leaves(arch):
        for rules, ref_rules in RULES.values():
            specs = []
            want_bytes = 0
            for t, ax in zip(leaves, axes):
                shape = tuple(t.shape)
                got = partition_spec_for(ax, shape, sizes, rules)
                want = ref.partition_spec_for(ax, shape, amesh, ref_rules)
                assert got == _as_tuple(want), (arch, mesh_name, rules.name, ax, shape)
                assert shard_shape(shape, got, sizes) == \
                    NamedSharding(amesh, want).shard_shape(shape)
                specs.append(got)
                want_bytes += int(np.prod(NamedSharding(amesh, want).shard_shape(shape))) \
                    * t.element_size()
            got_bytes = bytes_per_device({f"{i:05d}": t for i, t in enumerate(leaves)},
                                         {f"{i:05d}": s for i, s in enumerate(specs)}, sizes)
            assert got_bytes == want_bytes


# ---------------------------------------------------------------------------
# Property: the resolution never reuses an axis and only shards divisible dims
# ---------------------------------------------------------------------------

_LOGICAL = sorted(TRAIN_RULES.rules)


@settings(max_examples=200, deadline=None)
@given(axes=st.lists(st.sampled_from(_LOGICAL), min_size=1, max_size=5),
       dims=st.lists(st.sampled_from([1, 2, 3, 4, 6, 8, 12, 16, 25, 32, 48, 64, 96, 128]),
                     min_size=5, max_size=5),
       mesh_name=st.sampled_from(sorted(MESHES) + ["4x2"]),
       rules_name=st.sampled_from(sorted(RULES)))
def test_resolution_property(axes, dims, mesh_name, rules_name):
    sizes = MESHES.get(mesh_name, {"data": 4, "model": 2})
    rules = RULES[rules_name][0]
    shape = tuple(dims[:len(axes)])
    spec = partition_spec_for(tuple(axes), shape, sizes, rules)
    used = []
    for d, entry in enumerate(spec):
        names = (entry,) if isinstance(entry, str) else entry or ()
        n = 1
        for name in names:
            n *= sizes[name]
        used += list(names)
        assert shape[d] % n == 0
    assert len(used) == len(set(used))
    assert spec == _as_tuple(ref.partition_spec_for(tuple(axes), shape, _abstract(sizes),
                                                    RULES[rules_name][1]))
