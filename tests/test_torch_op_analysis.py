"""``repro_torch.launch.op_analysis`` (the counterpart of
``test_hlo_analysis.py``): the counter must charge a loop every
iteration, count an unlooped product exactly (and as the reference's
HLO analysis counts the same ``jax.jit`` program), charge slice writes
once, and on a (16, 16) fake mesh count one device's share of a sharded
product plus its all-gather's ring bytes.  Every count is exact."""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.launch import hlo_analysis as HA
from repro_torch.launch.mesh import fake_group, make_production_mesh
from repro_torch.launch.op_analysis import OpCounter


def test_loop_flops_counted_every_iteration():
    n, d, trips = 64, 128, 10
    w = torch.ones((trips, d, d))
    x = torch.ones((n, d))
    with OpCounter() as c:
        for i in range(trips):
            x = torch.tanh(x @ w[i])
    assert c.stats().flops == 2.0 * n * d * d * trips
    assert c.stats().ops >= 2 * trips  # a matmul and a tanh each time


def test_weight_counts_one_iteration_for_many():
    n, d = 8, 16
    x, w = torch.ones((n, d)), torch.ones((d, d))
    with OpCounter() as c:
        c.weight = 5
        x @ w
    assert c.stats().flops == 5 * 2.0 * n * d * d


def test_unlooped_product_exact_and_equal_to_reference():
    a = torch.ones((32, 64))
    b = torch.ones((64, 48))
    with OpCounter() as c:
        a @ b
    assert c.stats().flops == 2.0 * 32 * 64 * 48
    compiled = jax.jit(lambda a, b: a @ b).lower(
        jnp.ones((32, 64), jnp.float32),
        jnp.ones((64, 48), jnp.float32)).compile()
    assert c.stats().flops == HA.analyze(compiled.as_text()).flops
    # its traffic: both operands read, the output written, once each
    assert c.stats().hbm_bytes == 4 * (32 * 64 + 64 * 48 + 32 * 48)


def test_slice_writes_charged_once():
    """Writing row i of a (trips, d) buffer is charged the row, not the
    buffer (the meaning of ``test_hbm_model_ignores_scan_carry_buffers``)."""
    trips, d = 1000, 64
    c0 = torch.ones((d,))
    with OpCounter() as c:
        buf = torch.empty((trips, d))
        for i in range(trips):
            c0 = torch.tanh(c0)
            buf[i] = c0
    row = d * 4
    # each step: tanh reads and writes a row, the write moves one row in
    assert c.stats().hbm_bytes == trips * (2 * row + 2 * row)
    assert c.stats().hbm_bytes < 40 * trips * row


def test_sharded_product_on_a_16x16_fake_mesh():
    """(m, k) rows over "data" times (k, n) columns over "model": each of
    the 256 devices multiplies its (m/16, k) by (k, n/16) and the (k, n)
    operand, stored with k over "data", is all-gathered over 16 devices
    first (ring bytes: the gathered block × 15/16)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    m, k, n = 4096, 8192, 8192
    with fake_group(256):
        mesh = make_production_mesh(device_type="cpu")
        a = distribute_tensor(torch.empty((m, k), device="meta",
                                          dtype=torch.bfloat16), mesh,
                              [Shard(0), Replicate()])
        b = distribute_tensor(torch.empty((k, n), device="meta",
                                          dtype=torch.bfloat16), mesh,
                              [Shard(0), Shard(1)])
        with OpCounter() as c:
            y = a @ b.redistribute(mesh, [Replicate(), Shard(1)])
        st = c.stats()
        assert tuple(y.placements) == (Shard(0), Shard(1))
    assert st.flops == 2.0 * m * n * k / 256
    assert st.collective_ops == {"all-gather": 1}
    gathered = k * (n // 16) * 2
    assert st.wire_bytes == pytest.approx(gathered * 15 / 16, rel=0, abs=0)
    assert st.largest_group == 16
