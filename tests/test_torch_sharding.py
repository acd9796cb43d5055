"""The port's distribution layer held against the JAX package on the
CPU: the logical-axis rules (``distributed.sharding``), the training
meshes (``launch.mesh``), the logical axes of caches and optimizer state,
int8 gradient compression (``distributed.compression``), and the API
leftovers of the slice: ``layers.layernorm`` and the functional
optimizer.

The rules run on ``DeviceMesh``\\ es of a one-rank gloo world in this
process (a module fixture starts and ends it); the compressed
all-reductions in spawned gloo worlds of 2 and 4 ranks
(``launch.forcedevices.run_ranks``, each with a timeout).

Tolerances: specs, logical trees, ``q`` and ``scale`` are equal exactly
(``torch.round`` and ``jnp.round`` both round half to even); the error
feedback's outputs bit for bit over 50 steps; the compressed sums within
1e-6 of their largest entry (the ranks' scales are summed in the
collective's order, the reference's in rank order); layernorm within
1e-6 (one fp32 rsqrt); the functional optimizer's parameters within 1e-6
of each leaf's largest entry plus 1e-2 of the learning rate a step (the
rule of ``test_torch_recsys_models.py``) and its moments within 1e-6.
"""

import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro import configs as jconfigs
from repro.compat import make_mesh
from repro.distributed import compression as JC
from repro.distributed import sharding as JS
from repro.launch.cells import _abstract_init
from repro.models import gnn as JG
from repro.models import layers as JL
from repro.models import recsys as JR
from repro.models import transformer as JT
from repro.train import optimizer as jopt

from repro_torch.configs import REGISTRY, get_arch
from repro_torch.distributed import compression as TC
from repro_torch.distributed import sharding as TS
from repro_torch.launch.forcedevices import free_port, run_ranks
from repro_torch.launch.gnn_ranks import rank_checks
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.train import optimizer as topt
from repro_torch.tree import flatten_with_paths, is_axes

RANK_TIMEOUT_S = 120.0
MESH_AXES = {"dm": ("data", "model"), "pdm": ("pod", "data", "model")}


@pytest.fixture(scope="module")
def world1():
    """A one-rank gloo world in this process, and its meshes by axes."""
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        yield {k: make_host_mesh((1,) * len(v), v)
               for k, v in MESH_AXES.items()}
    finally:
        dist.destroy_process_group()


def _jmesh(key):
    axes = MESH_AXES[key]
    return make_mesh((1,) * len(axes), axes)


def _jspec(spec):
    return tuple(spec)


def _init_jax(arch_id, full: bool):
    """The JAX arch's (abstract params, logical tree) at its full or
    smoke config."""
    spec = jconfigs.get_arch(arch_id)
    cfg = spec.config_fn(None) if full else spec.smoke_config_fn()
    fam = spec.family
    if fam == "lm":
        def init():
            return JT.init_params(jax.random.PRNGKey(0), cfg)
    elif fam == "gnn":
        def init():
            return JG.init_params(jax.random.PRNGKey(0), cfg)
    else:
        fn = {"sasrec": JR.sasrec_init, "din": JR.din_init,
              "xdeepfm": JR.xdeepfm_init,
              "two-tower-retrieval": JR.twotower_init}[arch_id]

        def init():
            return fn(jax.random.PRNGKey(0), cfg)
    return _abstract_init(init)


def _axes_leaves(tree, prefix=""):
    """(path, logical tuple) of every leaf of a logical tree."""
    if is_axes(tree):
        return [(prefix, tree)]
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = []
    for k, v in items:
        out += _axes_leaves(v, f"{prefix}/{k}")
    return out


# ---------------------------------------------------------------------------
# logical-axis rules
# ---------------------------------------------------------------------------

RULE_CASES = [  # (logical, mesh key or None, rules override)
    (("batch", None, "act_ff"), "dm", {}),
    (("nope_axis",), "dm", {}),
    (("batch",), "dm", {}),
    (("batch",), "pdm", {}),
    (("batch",), None, {}),
    (("a1", "a2"), "dm", {"a1": "model", "a2": "model"}),
    (("kv_heads",), "dm", {"kv_heads": None}),
    (("nodes", "hidden"), "pdm", {}),
    (("batch", "candidates", "vocab"), "pdm", {}),
    (("zero", "batch"), "pdm", {}),
    ((None, "batch", "kv_seq", "kv_heads", None), "pdm", {}),
]


@pytest.mark.parametrize("logical,key,rules", RULE_CASES)
def test_logical_spec_matches_jax(world1, logical, key, rules):
    """The cases of ``tests/test_distributed.py`` (resolution, unknown
    names, "pod" dropped, no axis reuse, scoped rules) and multi-axis
    entries on a (pod, data, model) mesh."""
    with JS.use_rules(rules), TS.use_rules(rules):
        want = JS.logical_spec(logical, None if key is None else _jmesh(key))
        got = TS.logical_spec(logical, None if key is None else world1[key])
    assert got == _jspec(want)


def test_use_rules_is_scoped_and_active_mesh_resolves(world1):
    base = TS.logical_spec(("kv_heads",), world1["dm"])
    with TS.use_rules({"kv_heads": None}):
        assert TS.logical_spec(("kv_heads",), world1["dm"]) == (None,)
    assert TS.logical_spec(("kv_heads",), world1["dm"]) == base == ("model",)
    assert TS.logical_spec(("batch",)) == (None,)
    with TS.active_mesh(world1["pdm"]):
        assert TS.logical_spec(("batch",)) == (("pod", "data"),)
    assert TS.current_rules() is TS.DEFAULT_RULES
    assert TS.MULTI_POD_RULES == JS.MULTI_POD_RULES
    assert TS.DEFAULT_RULES == JS.DEFAULT_RULES


@pytest.mark.parametrize("arch_id", sorted(REGISTRY))
def test_arch_param_specs_and_divisibility_match_jax(world1, arch_id):
    """Every logical leaf of the arch's full-config tree resolves to JAX's
    spec on both meshes, under the arch's rules; and
    ``divisibility_report`` on the production meshes' shapes (16 x 16 and
    2 x 16 x 16, by axis sizes) gives JAX's report for every leaf."""
    params_a, logical = _init_jax(arch_id, full=True)
    shapes = {p: s.shape for p, s in flatten_with_paths(params_a)}
    spec = get_arch(arch_id)
    sizes = {"dm": {"data": 16, "model": 16},
             "pdm": {"pod": 2, "data": 16, "model": 16}}

    class FakeMesh:                 # the production mesh's shape only
        def __init__(self, key):
            self.axis_names = MESH_AXES[key]
            self.shape = sizes[key]

    with JS.use_rules(spec.rules_override), TS.use_rules(spec.rules_override):
        for key in MESH_AXES:
            for path, names in _axes_leaves(logical):
                want = JS.logical_spec(names, _jmesh(key))
                got = TS.logical_spec(names, world1[key])
                assert got == _jspec(want), (key, path)
                shape = shapes[path.lstrip("/")]
                assert TS.divisibility_report(shape, got, sizes[key]) == \
                    JS.divisibility_report(shape, want, FakeMesh(key)), path


def test_make_param_shardings_on_a_one_rank_mesh(world1):
    """GraphSAGE's logical tree on (data, model) and a multi-axis entry on
    (pod, data, model): specs equal to JAX's ``NamedSharding`` specs,
    placements a ``Shard(dim)`` per named mesh dimension; ``shard_like``
    makes DTensors of the same values; ``constrain`` redistributes a
    DTensor and is the identity for a plain tensor."""
    _, logical = _init_jax("graphsage-reddit", full=False)
    mesh = world1["dm"]
    got = TS.make_param_shardings(mesh, logical)
    want = JS.make_param_shardings(_jmesh("dm"), logical)
    assert [s.spec for s in jax.tree.leaves(got)] == \
        [_jspec(s.spec) for s in jax.tree.leaves(want)]
    w = got["layers"][0]["w_self"]
    assert w.spec == (None, "model")
    assert w.placements == (Replicate(), Shard(1))
    assert got["head"]["bias"].placements == (Replicate(), Replicate())
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    tree = TS.shard_like({"w": x, "b": [x[0]]},
                         {"w": w, "b": [got["head"]["bias"]]})
    assert isinstance(tree["w"], DTensor)
    assert torch.equal(tree["w"].full_tensor(), x)
    assert torch.equal(tree["b"][0].to_local(), x[0])
    pdm = world1["pdm"]
    s = TS.make_param_shardings(pdm, {"a": ("batch", "hidden")})["a"]
    assert s.spec == (("pod", "data"), "model")
    assert s.placements == (Shard(0), Shard(0), Shard(1))
    with pytest.raises(ValueError, match="order"):
        TS.placements((("data", "pod"),), pdm)
    with TS.active_mesh(mesh):
        assert TS.constrain(x, ("nodes", "hidden")) is x
        c = TS.constrain(tree["w"], ("nodes", "feat"))
        assert c.placements == (Shard(0), Replicate())
        assert torch.equal(c.full_tensor(), x)
    assert TS.constrain(tree["w"], ("nodes", "feat")) is tree["w"]


def test_meshes_need_their_world(world1):
    mesh = world1["dm"]
    assert tuple(mesh.mesh_dim_names) == ("data", "model")
    assert tuple(mesh.shape) == (1, 1)
    with pytest.raises(ValueError, match="256 ranks"):
        make_production_mesh()
    with pytest.raises(ValueError, match="512 ranks"):
        make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_host_mesh((2, 1))
    with pytest.raises(ValueError, match="does not match"):
        make_host_mesh((1,), ("data", "model"))


# ---------------------------------------------------------------------------
# logical axes of caches and optimizer state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch_id", sorted(a for a in REGISTRY
                                           if REGISTRY[a].family == "lm"))
def test_cache_logical_equals_jax(arch_id):
    jcfg = jconfigs.get_arch(arch_id).config_fn(None)
    tcfg = get_arch(arch_id).config_fn(None)
    assert TT.cache_logical(tcfg) == JT.cache_logical(jcfg)


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch_id", sorted(REGISTRY))
def test_opt_state_logical_equals_jax(arch_id, kind):
    _, logical = _init_jax(arch_id, full=False)
    want = jopt.opt_state_logical(logical, jopt.OptConfig(kind=kind))
    got = topt.opt_state_logical(logical, topt.OptConfig(kind=kind))
    assert got == want


# ---------------------------------------------------------------------------
# int8 compression
# ---------------------------------------------------------------------------

def _quant_inputs():
    rng = np.random.default_rng(0)
    ties = (np.arange(-20, 21, dtype=np.float32) + 0.5) * (127 / 20.5)
    return {"normal": (rng.normal(size=(64, 64)) * 3).astype(np.float32),
            "ties": ties,                  # x / scale hits k + 0.5
            "zeros": np.zeros((5, 3), np.float32),
            "tiny": (rng.normal(size=100) * 1e-14).astype(np.float32),
            "wide": (rng.standard_cauchy(size=(7, 9, 11)) * 1e4
                     ).astype(np.float32)}


@pytest.mark.parametrize("name", sorted(_quant_inputs()))
def test_quantize_int8_bit_equal_to_jax(name):
    x = _quant_inputs()[name]
    jq, js = JC.quantize_int8(jnp.asarray(x))
    tq, ts = TC.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tq.numpy().tobytes() == np.asarray(jq).tobytes()
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    jd = JC.dequantize_int8(jq, js)
    td = TC.dequantize_int8(tq, ts)
    assert td.numpy().tobytes() == np.asarray(jd).tobytes()
    if name == "normal":            # the JAX test's round-trip bound
        assert float((td - torch.from_numpy(x)).abs().max()) <= \
            float(ts) * 0.51 + 1e-6
    assert TC.dequantize_int8(tq, ts, torch.bfloat16).dtype == torch.bfloat16


def test_error_feedback_equals_jax_over_50_steps():
    rng = np.random.default_rng(1)
    g = {"w": rng.normal(size=(32,)).astype(np.float32),
         "m": [rng.normal(size=(4, 6)).astype(np.float32)]}
    jg = jax.tree.map(jnp.asarray, g)
    tg = jax.tree.map(torch.from_numpy, g)
    jres, tres = JC.ErrorFeedback.init(jg), TC.ErrorFeedback.init(tg)
    acc = np.zeros(32)
    for _ in range(50):
        jcomp, jres = JC.ErrorFeedback.apply(jg, jres)
        tcomp, tres = TC.ErrorFeedback.apply(tg, tres)
        for a, b in ((tcomp, jcomp), (tres, jres)):
            fa, fb = flatten_with_paths(a), flatten_with_paths(
                jax.tree.map(np.asarray, b))
            assert [p for p, _ in fa] == [p for p, _ in fb]
            for (p, x), (_, y) in zip(fa, fb, strict=True):
                assert x.numpy().tobytes() == y.tobytes(), p
        acc += tcomp["w"].numpy()
    np.testing.assert_allclose(acc / 50, g["w"], atol=0.02)


def _psum_want(xs, members):
    """The compressed sum over ``members`` from JAX's ``quantize_int8``:
    the int32 sum of the payloads times the mean scale."""
    out = {}
    for k in xs[0]:
        qs = [JC.quantize_int8(jnp.asarray(xs[r][k])) for r in members]
        acc = sum(np.asarray(q, np.int64) for q, _ in qs)
        scale = np.float32(sum(float(s) for _, s in qs) / len(members))
        out[k] = acc.astype(np.float32) * scale
    return out


@pytest.mark.parametrize("world,shape", [(2, (2, 1, 1)), (4, (2, 2, 1))])
def test_compressed_allreduce_in_gloo_worlds(world, shape):
    """``compressed_psum_int8`` over the world and the cross-pod mean over
    the mesh's ``pod`` groups (ranks r and r + world/2), each rank with
    its own gradients."""
    rng = np.random.default_rng(world)
    xs = [{"w": (rng.normal(size=(16, 16)) * (r + 1)).astype(np.float32),
           "b": rng.normal(size=(16,)).astype(np.float32)}
          for r in range(world)]
    out = [r["comp"] for r in run_ranks(
        rank_checks, world, ((), (shape, MESH_AXES["pdm"], xs)),
        timeout_s=RANK_TIMEOUT_S)]
    full = _psum_want(xs, range(world))
    half = world // 2
    for r, (psum, cross) in enumerate(out):
        pod = _psum_want(xs, (r % half, r % half + half))
        for k in full:
            for got, want in ((psum[k], full[k]), (cross[k], pod[k] / 2)):
                scale = float(np.abs(want).max())
                assert float(np.abs(got - want).max()) <= 1e-6 * scale, \
                    (world, r, k)


def test_crosspod_allreduce_without_a_pod_axis_is_the_identity(world1):
    tree = {"w": torch.ones(3)}
    assert TC.compressed_crosspod_allreduce(tree, world1["dm"]) is tree
    x = torch.linspace(-1, 1, 64).reshape(8, 8)
    y = TC.compressed_psum_int8(x)          # a world of one: the JAX bound
    assert float((y - x).abs().max()) < 1e-2


# ---------------------------------------------------------------------------
# API leftovers: layernorm and the functional optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dtype):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(6, 5, 24)).astype(np.float32) * 3 + 1
    scale = rng.normal(size=24).astype(np.float32)
    bias = rng.normal(size=24).astype(np.float32)
    jp, jlog = JL.layernorm_init(24, jnp.float32)
    tp, tlog = TL.layernorm_init(24, torch.float32, device="cpu")
    assert tlog == jlog
    for k in ("scale", "bias"):
        assert np.array_equal(getattr(tp, k).detach().numpy(),
                              np.asarray(jp[k]))
    with torch.no_grad():
        tp.scale.copy_(torch.from_numpy(scale))
        tp.bias.copy_(torch.from_numpy(bias))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = JL.layernorm({"scale": jnp.asarray(scale),
                         "bias": jnp.asarray(bias)}, jx)
    got = TL.layernorm(tp, tx)
    assert got.dtype == tx.dtype
    want = np.asarray(want.astype(jnp.float32))
    err = float(np.abs(got.float().numpy() - want).max())
    tol = 1e-6 if dtype == "float32" else 1e-2   # one bf16 rounding
    assert err <= tol * float(np.abs(want).max())


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_functional_optimizer_matches_jax(kind):
    rng = np.random.default_rng(3)
    params = {"w": rng.normal(size=(8, 6)).astype(np.float32),
              "layers": [{"b": rng.normal(size=(6,)).astype(np.float32)},
                         {"k": rng.normal(size=(2, 3, 4)).astype(np.float32)}]}
    cfg = topt.OptConfig(kind=kind, lr=1e-3, warmup_steps=1, decay_steps=10)
    ocfg = jopt.OptConfig(**dataclasses.asdict(cfg))
    jp = jax.tree.map(jnp.asarray, params)
    tp = jax.tree.map(torch.from_numpy, params)
    init = {"adamw": (jopt.adamw_init, topt.adamw_init),
            "adafactor": (jopt.adafactor_init, topt.adafactor_init)}[kind]
    js, ts = init[0](jp), init[1](tp)
    assert [(p, tuple(x.shape)) for p, x in flatten_with_paths(ts)] == \
        [(p, x.shape) for p, x in flatten_with_paths(
            jax.tree.map(np.asarray, js))]
    before = {p: x.clone() for p, x in flatten_with_paths(tp)}
    for i in range(2):
        grads = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 2
                                        ).astype(np.float32), params)
        jp, js, jm = jopt.opt_update(jp, jax.tree.map(jnp.asarray, grads), js,
                                     ocfg)
        upd = topt.adamw_update if kind == "adamw" else topt.adafactor_update
        tp2, ts, tm = (topt.opt_update if i else upd)(
            tp, jax.tree.map(torch.from_numpy, grads), ts, cfg)
        if i == 0:
            for p, x in flatten_with_paths(tp):
                assert torch.equal(x, before[p]), "inputs changed"
        tp = tp2
        assert abs(tm["lr"] - float(jm["lr"])) <= 1e-9
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-6 * float(jm["grad_norm"])
    for a, b, what in ((tp, jp, "params"), (ts, js, "state")):
        for (p, x), (_, y) in zip(flatten_with_paths(a), flatten_with_paths(
                jax.tree.map(np.asarray, b)), strict=True):
            y = np.asarray(y, np.float64)
            atol = 2 * 1e-2 * cfg.lr if what == "params" else 0.0
            assert float(np.abs(x.double().numpy() - y).max()) <= \
                1e-6 * max(float(np.abs(y).max()), 1e-30) + atol, (what, p)
