"""The recurrent families' decode-against-forward gap at full depth is the
reference's own, not a fault of the port.

On the card, ``chip_smoke.py``'s non-dense phase finds recurrentgemma-2b
and xlstm-1.3b serving logits 0.3564 and 4.0254 from ``forward``, above
``NEAR_TIE_LIMIT``, and leaves both out of ``E2E_HELD``.  Here both
packages run the same model at smoke widths and the published depth
(recurrentgemma 26 layers, xlstm 48): the reference's init with the
``WAKE`` leaves seeded (as in ``test_torch_models.py``), the reference
compiled with excess precision off (``_strict``), B = 2, a 32-token
prompt, then 8 ``decode_step``s, each compared with ``forward`` over the
same 40 tokens at the same position.

Measured here (largest |logit| difference over the 8 steps; the largest
logit is 4.2-4.4)::

    family, layers        ref decode-forward  port decode-forward  port-ref decode
    xlstm, 48             4.4688              4.4688               0.1367
    recurrentgemma, 26    0.4336              0.4209               0.1445

So the reference's decode path is as far from its ``forward`` as the
port's is, on the CPU and on the card alike.  Held: the reference's gap
above ``NEAR_TIE_LIMIT``; the port's gap within ``GAP_TOL`` of it
(0.0127 measured, recurrentgemma); the port's decode within
``DECODE_TOL`` of the reference's (0.1445 measured).
"""
import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro.models.sharding import ShardCtx
from repro_torch import configs as tconfigs
from repro_torch.models import model as TM

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

CTX = ShardCtx(None)
B, PROMPT, STEPS = 2, 32, 8
# the same leaves and scales as tests/test_torch_models.py
WAKE = {"xgate": 1.0, "mgate": 1.0, "r_z": 0.5, "r_i": 0.5, "r_f": 0.5,
        "r_o": 0.5, "conv_b": 0.1, "scale": 0.1, "bias": 0.1,
        "q_norm": 0.1, "k_norm": 0.1}
STRICT = {"xla_allow_excess_precision": False}
GAP_TOL = 0.05  # 0.0127 measured x 4
DECODE_TOL = 0.3  # 0.1445 measured x 2, under the reference's own 0.35
# (arch, published depth, the reference's gap measured at these seeds)
CASES = (("xlstm_1_3b", 48, 4.4688), ("recurrentgemma_2b", 26, 0.4336))


def _strict(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=STRICT)


def _wake(tree, rng, key=None):
    if isinstance(tree, dict):
        return {k: _wake(v, rng, k) for k, v in tree.items()}
    a = np.asarray(tree, np.float32)
    if key in WAKE:
        a = (rng.standard_normal(a.shape) * WAKE[key]).astype(np.float32)
    return a


def _gaps(arch, layers):
    """Forward over all tokens and the 8 decode steps' logits, per
    package, as (B, STEPS, V) f32."""
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch),
                               num_layers=layers)
    tcfg = dataclasses.replace(tconfigs.smoke_config(arch),
                               num_layers=layers)
    params = jax.tree_util.tree_map(
        np.asarray, JM.init_model(jax.random.key(0), jcfg))
    params = _wake(params, np.random.default_rng(7))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    model = TM.from_reference_params(params, tcfg, device="cpu")
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (B, PROMPT + STEPS)).astype(np.int32)

    batch = {"tokens": jnp.asarray(toks)}
    fj = _strict(lambda p, b: JM.forward(p, jcfg, b, CTX)[0], jp,
                 batch)(jp, batch)
    ft = TM.forward(model, torch.from_numpy(toks))[0]

    cj = JM.init_cache(jcfg, B, PROMPT + STEPS)
    ct = TM.init_cache(model, B, PROMPT + STEPS)
    head = {"tokens": jnp.asarray(toks[:, :PROMPT])}
    _, cj = _strict(lambda p, b, c: JM.prefill(p, jcfg, b, c, CTX), jp,
                    head, cj)(jp, head, cj)
    _, ct = TM.prefill(model, torch.from_numpy(toks[:, :PROMPT]), ct)
    step = _strict(lambda p, c, t: JM.decode_step(p, jcfg, c, t, CTX), jp,
                   cj, jnp.asarray(toks[:, :1]))
    dj, dt = [], []
    for i in range(PROMPT, PROMPT + STEPS):
        tok = toks[:, i:i + 1]
        lj, cj = step(jp, cj, jnp.asarray(tok))
        lt, ct = TM.decode_step(model, ct, torch.from_numpy(tok))
        dj.append(np.asarray(lj, np.float32)[:, 0])
        dt.append(lt.float().numpy()[:, 0])
    return {"ref forward": np.asarray(fj, np.float32)[:, PROMPT:],
            "port forward": ft.float().numpy()[:, PROMPT:],
            "ref decode": np.stack(dj, 1), "port decode": np.stack(dt, 1)}


@pytest.mark.parametrize("arch,layers,measured", CASES,
                         ids=[f"{a}-{n}" for a, n, _ in CASES])
def test_full_depth_gap_is_the_references_own(arch, layers, measured):
    r = _gaps(arch, layers)
    ref_gap = float(np.abs(r["ref decode"] - r["ref forward"]).max())
    port_gap = float(np.abs(r["port decode"] - r["port forward"]).max())
    vs_ref = float(np.abs(r["port decode"] - r["ref decode"]).max())
    assert ref_gap > chip_smoke.NEAR_TIE_LIMIT
    assert ref_gap == pytest.approx(measured, abs=GAP_TOL)
    assert abs(port_gap - ref_gap) < GAP_TOL
    assert vs_ref < DECODE_TOL
