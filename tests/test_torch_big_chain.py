"""PyTorch port: the north-star chain (workloads/big_chain.py) held
against the JAX package's ``matrel_tpu/workloads/big_chain.py`` and a
float64 numpy oracle on the CPU, at tests/test_workloads.py's shapes
(n = 64, tile 8, panel 16).

Tolerances:
- Generators: ``cheap_gen`` bit for bit (the same f32 ops in the same
  order, no fused multiply-add); ``default_gen`` within two f32 spacings
  of ``scale``: the two packages' ``sin`` may differ by one ulp of a value
  below 1, which ``· scale`` and its rounding carry to at most that.
- Chains, relative to the oracle's Frobenius² ("fro") or to Σ|O| ("sum",
  whose signed total cancels): f32 1e-5 against the JAX function (the
  same product summed in another order) and 1e-4 against float64 (the
  JAX package's own bounds); bf16 1e-5 against the JAX slab schedule (the
  same bf16 operands, T rounded once) and 1e-4 against a float64 oracle
  that rounds the operands and T to bf16 as the body does. The JAX
  package's tile-assembly schedule at bf16 rounds some 0.3% of its
  generated operands to the neighbouring bf16 value on the CPU (its
  fused loop computes some f32 coordinates one ulp apart from its own
  generators); one ulp is at most 2^-7 relative, so three operands
  with 0.3% of entries moved shift the result by at most ~6·0.003·2^-7 =
  1.4e-4: the port is held to 1e-3 there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matrel_tpu.workloads import big_chain as J
from matrel_tpu_torch.core.mesh import DeviceUnavailableError
from matrel_tpu_torch.workloads import big_chain as T

N, TILE, PANEL, SCALE = 64, 8, 16, 0.05
SEEDS = (1, 2, 3)
GENS = ("cheap_gen", "default_gen")
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
#: default_gen: one ulp of sin (< 2^-24 below 1) times scale, plus the
#: product's rounding — within two f32 spacings of scale.
SIN_ATOL = 2 * float(np.spacing(np.float32(SCALE)))


def _gens(kind, dtype_name, tile=TILE):
    tdt, jdt = DTYPES[dtype_name]
    return (tuple(getattr(T, kind)(s, tile, tdt, SCALE, device="cpu")
                  for s in SEEDS),
            tuple(getattr(J, kind)(s, tile, jdt, SCALE) for s in SEEDS))


def _np(t):
    return t.float().numpy().astype(np.float64)


def _oracle(tgens, dtype_name):
    """(fro, sum, Σ|O|) in float64 of the chain over the generated
    operands; at bf16, T = A·B is rounded to bf16 as the body does."""
    A, B, C = (_np(g.slab(0, 0, (N, N))) for g in tgens)
    Tm = A @ B
    if dtype_name == "bfloat16":
        Tm = _np(torch.from_numpy(Tm).float().to(torch.bfloat16))
    O = Tm @ C
    return float((O * O).sum()), float(O.sum()), float(np.abs(O).sum())


def _scale(oracle, reduce):
    fro, _, abs_sum = oracle
    return fro if reduce == "fro" else abs_sum


@pytest.mark.parametrize("kind", GENS)
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("bi,bj", [(0, 0), (1, 2), (7, 3), (5, 7)])
def test_gen_tiles_match_jax(kind, seed, bi, bj):
    tg = getattr(T, kind)(seed, TILE, torch.float32, SCALE, device="cpu")
    jg = getattr(J, kind)(seed, TILE, jnp.float32, SCALE)
    got = tg(bi, bj).numpy()
    # a traced index, as the JAX package's tile loop passes it
    want = np.asarray(jg(jnp.int32(bi), jnp.int32(bj)))
    atol = 0.0 if kind == "cheap_gen" else SIN_ATOL
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    # the tile is the slab at its coordinates
    np.testing.assert_array_equal(
        got, tg.slab(bi * TILE, bj * TILE, (TILE, TILE)).numpy())


@pytest.mark.parametrize("kind", GENS)
@pytest.mark.parametrize("dtype_name", DTYPES)
@pytest.mark.parametrize("r0,c0,shape", [(0, 0, (N, N)), (16, 8, (16, 64)),
                                         (8, 40, (56, 8))])
def test_gen_slabs_match_jax(kind, dtype_name, r0, c0, shape):
    tg, jg = (g[0] for g in _gens(kind, dtype_name))
    got = tg.slab(r0, c0, shape)
    want = np.asarray(jg.slab(r0, c0, shape)).astype(np.float64)
    assert got.dtype == DTYPES[dtype_name][0]
    assert tuple(got.shape) == shape
    if kind == "cheap_gen":
        np.testing.assert_array_equal(_np(got), want)
    else:
        # at bf16 a sin ulp may move the value across a rounding
        # boundary: one bf16 spacing at scale
        atol = (SIN_ATOL if dtype_name == "float32"
                else 2.0 ** -8 * SCALE)
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=atol)


@pytest.mark.parametrize("kind", GENS)
@pytest.mark.parametrize("dtype_name", DTYPES)
@pytest.mark.parametrize("reduce", ["fro", "sum"])
@pytest.mark.parametrize("schedule", ["streaming_chain",
                                      "streaming_chain_slab"])
def test_chain_matches_jax_and_oracle(kind, dtype_name, reduce, schedule):
    tgens, jgens = _gens(kind, dtype_name)
    tdt, jdt = DTYPES[dtype_name]
    got = getattr(T, schedule)(N, *tgens, tile=TILE, panel=PANEL,
                               dtype=tdt, reduce=reduce)
    assert got.dtype == torch.float32 and got.dim() == 0
    got = float(got)
    want = float(getattr(J, schedule)(N, *jgens, tile=TILE, panel=PANEL,
                                      dtype=jdt, reduce=reduce))
    oracle = _oracle(tgens, dtype_name)
    scale = _scale(oracle, reduce)
    ref = oracle[0] if reduce == "fro" else oracle[1]
    if dtype_name == "float32" or schedule == "streaming_chain_slab":
        jax_tol = 1e-5
    else:
        jax_tol = 1e-3       # the JAX tile-assembly's bf16 operands
    assert abs(got - want) <= jax_tol * scale, (got, want)
    assert abs(got - ref) <= 1e-4 * scale, (got, ref)


@pytest.mark.parametrize("kind", GENS)
@pytest.mark.parametrize("dtype_name", DTYPES)
def test_schedules_agree(kind, dtype_name):
    """The slab and tile-assembly schedules on the same operands: the
    same products accumulated in another order (JAX test: rel 1e-5)."""
    tgens, _ = _gens(kind, dtype_name)
    tdt = DTYPES[dtype_name][0]
    slab = float(T.streaming_chain_slab(N, *tgens, tile=TILE, panel=PANEL,
                                        dtype=tdt))
    accum = float(T.streaming_chain(N, *tgens, tile=TILE, panel=PANEL,
                                    dtype=tdt))
    assert slab == pytest.approx(accum, rel=1e-5)


@pytest.mark.parametrize("schedule", ["streaming_chain",
                                      "streaming_chain_slab"])
@pytest.mark.parametrize("n,tile,panel", [(60, 8, 16), (64, 8, 12),
                                          (64, 16, 8)])
def test_rejects_misaligned(schedule, n, tile, panel):
    g = T.cheap_gen(0, tile, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        getattr(T, schedule)(n, g, g, g, tile=tile, panel=panel)


def test_slab_requires_capable_gens():
    def plain(i, j):
        return torch.zeros((TILE, TILE))

    with pytest.raises(ValueError, match="slab"):
        T.streaming_chain_slab(N, plain, plain, plain, tile=TILE,
                               panel=PANEL)
    # the tile-assembly schedule takes any tile generator
    g = T.cheap_gen(1, TILE, torch.float32, SCALE, device="cpu")
    assert float(T.streaming_chain(N, plain, g, g, tile=TILE,
                                   panel=PANEL, dtype=torch.float32)) == 0.0


@pytest.mark.parametrize("n", [64, 8192, 65_536])
def test_north_star_flops(n):
    assert T.north_star_flops(n) == J.north_star_flops(n) == 4.0 * n ** 3


def test_generators_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kind in GENS:
        with pytest.raises(DeviceUnavailableError):
            getattr(T, kind)(1, TILE)
        assert getattr(T, kind)(1, TILE, device="cpu").device.type == "cpu"
