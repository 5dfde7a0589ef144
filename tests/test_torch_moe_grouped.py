"""The DP-local MoE dispatch (``token_groups = G``) against the JAX package.

``repro.models.moe.moe_apply(..., token_groups=G)`` (its
``_moe_apply_grouped`` for G > 1) and the port's ``moe_apply`` take the
same weights (JAX's ``moe_init``, a hot expert planted in the router so
that some groups drop tokens) and the same numpy activations, with and
without an SBR table over replica slots.  The outputs and the gradients of
``sum(out * cotangent)`` with respect to the activations and every weight
(``jax.grad`` against ``torch.autograd.grad``) must agree:

* float32: within ``1e-5`` of each leaf's largest entry (the two
  frameworks sum in other orders; the picks and queues are integers and
  equal);
* bfloat16: within ``0.05`` of each leaf's largest entry (one rounding of
  a matmul output may land on the other side, 2^-8 relative, and the
  backward carries it), as the training tests hold bf16 gradients.

The stats are float32 in both packages and agree within ``1e-5``
(``dropped_frac`` and the load counts are exact counts of kept and
dropped pairs when the gates are equal).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe as tmoe

E, R, D, F, K = 8, 4, 32, 48, 2
N = 96                       # 2 x 48 tokens; groups of 96, 48 and 24
STATS = ("tokens_per_expert", "tokens_per_expert_router", "dropped_frac",
         "load_std", "aux_loss")


def _layer(R_):
    p = jmoe.moe_init(jax.random.PRNGKey(5), D, F, E, n_replica_slots=R_)
    p["router"] = p["router"].at[:, 0].add(2.0)      # a hot expert
    return {k: np.array(v) for k, v in p.items()}


def _table():
    """Expert 0 split over its slot and the first spare, expert 1 over its
    slot and the second, as the balancer writes an SBR table."""
    r = np.zeros((E, E + R), np.float32)
    r[np.arange(E), np.arange(E)] = 1.0
    r[0, 0], r[0, E] = 0.55, 0.45
    r[1, 1], r[1, E + 1] = 0.3, 0.7
    return r


def _inputs(seed=11):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, N // 2, D)).astype(np.float32)
    ct = rng.standard_normal((2, N // 2, D)).astype(np.float32)
    return x, ct


def _jax(p, x, ct, G, routing, dtype, cf):
    jdt = getattr(jnp, dtype)

    def f(p, x):
        out, st = jmoe.moe_apply(p, x.astype(jdt), top_k=K,
                                 capacity_factor=cf,
                                 expert_routing=routing, return_stats=True,
                                 token_groups=G)
        return jnp.sum(out.astype(jnp.float32) * ct), (out, st)

    jp = {k: jnp.asarray(v) for k, v in p.items()}
    (_, (out, st)), grads = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    return out, st, grads


def _port(p, x, ct, G, routing, dtype, cf):
    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True)
          for k, v in p.items()}
    tx = torch.from_numpy(x.copy()).requires_grad_(True)
    out, st = tmoe.moe_apply(tp, tx.to(getattr(torch, dtype)), top_k=K,
                             capacity_factor=cf,
                             expert_routing=(None if routing is None else
                                             torch.from_numpy(routing)),
                             return_stats=True, token_groups=G)
    loss = (out.float() * torch.from_numpy(ct)).sum()
    names = sorted(tp)
    grads = torch.autograd.grad(loss, [tp[k] for k in names] + [tx])
    return out, st, dict(zip(names, grads[:-1])), grads[-1]


def _close(got, want, rel, what):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        got, want, rtol=0, atol=rel * max(float(np.abs(want).max()), 1e-30),
        err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("routed", [False, True], ids=["plain", "sbr"])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_grouped_moe_matches_jax(G, routed, dtype):
    """Forward, stats and gradients at G = 1, 2, 4, capacity factor 1.25
    (the training forward): the hot expert's queues overflow in some
    groups, so tokens drop."""
    p = _layer(R if routed else 0)
    routing = _table() if routed else None
    x, ct = _inputs()
    jout, jst, (jgp, jgx) = _jax(p, x, ct, G, routing, dtype, 1.25)
    tout, tst, tgp, tgx = _port(p, x, ct, G, routing, dtype, 1.25)
    rel = 1e-5 if dtype == "float32" else 0.05
    assert tout.dtype == getattr(torch, dtype) and tout.shape == x.shape
    _close(tout, jout, rel, "out")
    assert float(jst["dropped_frac"]) > 0
    for k in STATS:
        np.testing.assert_allclose(tst[k].detach().numpy(),
                                   np.asarray(jst[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    for k in tgp:
        _close(tgp[k], jgp[k], rel, f"d{k}")
    _close(tgx, jgx, rel, "dx")
    if routed:                 # the split tables reached the replica slots
        assert float(tst["tokens_per_expert"][E:E + 2].detach().sum()) > 0


def test_groups_change_the_drops_not_the_kept_tokens():
    """Drop-free (capacity factor E / k), every group size gives the
    global dispatch's output: each token's experts and gates are the same,
    only the queues' layout differs."""
    p = {k: torch.from_numpy(v) for k, v in _layer(0).items()}
    x = torch.from_numpy(_inputs()[0])
    outs = [tmoe.moe_apply(p, x, top_k=K, capacity_factor=E / K,
                           token_groups=G) for G in (1, 2, 4, 8)]
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], rtol=0, atol=1e-6)


def test_token_groups_must_divide_the_tokens():
    p = {k: torch.from_numpy(v) for k, v in _layer(0).items()}
    x = torch.from_numpy(_inputs()[0])
    for G in (5, 7, 0):
        with pytest.raises(ValueError, match="token groups"):
            tmoe.moe_apply(p, x, top_k=K, token_groups=G)


@pytest.mark.parametrize("routed", [False, True], ids=["plain", "sbr"])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_rows_cover_exactly_each_slots_last_live_row(monkeypatch, G, routed):
    """K4 gets the queues slot by slot, ``[P, G * cap, D]``, and ``rows``:
    for each slot the end of its last live row (0 for a slot no group
    uses).  Every row before it that holds no token is the zero sentinel
    row; the three products get the same ``rows``."""
    calls = []
    k4_call = tmoe.k4.segment_matmul

    def spy(x, w, rows=None):
        calls.append((x, rows))
        return k4_call(x, w, rows)

    monkeypatch.setattr(tmoe.k4, "segment_matmul", spy)
    p = {k: torch.from_numpy(v) for k, v in _layer(R if routed else 0).items()}
    P = p["w_gate"].shape[0]
    x = torch.from_numpy(_inputs()[0])
    _, st = tmoe.moe_apply(
        p, x, top_k=K, capacity_factor=1.25, return_stats=True,
        expert_routing=torch.from_numpy(_table()) if routed else None,
        token_groups=G)
    assert len(calls) == 3
    h_in, rows = calls[0]
    cap = round(1.25 * (N // G) * K / E)
    assert h_in.shape == (P, G * cap, D)
    assert rows.dtype == torch.int32 and rows.shape == (P,)
    filled = h_in.abs().sum(-1) > 0                   # [P, G * cap]
    idx = torch.arange(G * cap)
    want = torch.where(filled, idx + 1, 0).amax(1).to(torch.int32)
    assert torch.equal(rows, want)
    # the live rows are the kept (token, slot) pairs; the dead rows inside
    # the prefixes are the sentinel
    dropped = round(float(st["dropped_frac"]) * N * P)
    assert int(filled.sum()) == N * K - dropped
    assert int(rows.sum()) >= int(filled.sum())
    for _, r in calls[1:]:
        assert torch.equal(r, rows)
