"""The Triton-route collide-stream kernel on the CPU: parity with the jnp
tier over lattice x collision x storage policy, masked tails and block
choice, periodic wrap, the launch-shape rules, the custom_vjp gradient,
the platform module, and the kernel's lowering for CUDA (which needs no
card: the Triton IR is built in Python)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import xlb_tpu as xlb
from tests.conftest import init_env
from xlb_tpu.boundary import EquilibriumBC, FullwayBounceBackBC
from xlb_tpu.grid import grid_factory
from xlb_tpu.kernels.collide_stream import build_fused_collide_stream, kernel_collision_spec
from xlb_tpu.kernels.fused_step import bc_to_spec, build_fused_step, build_fused_window, pack_masks
from xlb_tpu.models import IncompressibleNavierStokesStepper
from xlb_tpu.utils import tiers
from xlb_tpu.velocity_set import D2Q9, D3Q19, D3Q27

_SHAPES = {D2Q9: (12, 10), D3Q19: (8, 6, 5), D3Q27: (6, 6, 5)}


def _cavity(vs_cls, shape=None, collision="BGK"):
    """Walls + a moving equilibrium lid on a non-power-of-two box, with a
    perturbed initial state."""
    vs = init_env(vs_cls)
    shape = shape or _SHAPES[vs_cls]
    grid = grid_factory(shape, mesh_shape=(1,) * len(shape), devices=jax.devices()[:1])
    box = grid.bounding_box_indices()
    box_ne = grid.bounding_box_indices(remove_edges=True)
    faces = ("bottom", "left", "right") if vs.d == 2 else ("bottom", "left", "right", "front", "back")
    walls = np.unique(np.concatenate([np.asarray(box[k]) for k in faces], axis=1), axis=1)
    lid = (0.04,) + (0.0,) * (vs.d - 1)
    bcs = [FullwayBounceBackBC(indices=walls.tolist()), EquilibriumBC(rho=1.0, u=lid, indices=box_ne["top"])]
    st = IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs, collision_type=collision)
    f0, f1, bm, mm = st.prepare_fields()
    rng = np.random.default_rng(0)
    f0 = f0 * (1.0 + 0.01 * jnp.asarray(rng.standard_normal(f0.shape), f0.dtype))
    return st, f0, bm, mm


def _kernel(st, shape, block=None, store=jnp.float32, shifted=False, interpret=True):
    vs = st.velocity_set
    n = int(np.prod(shape))
    return build_fused_collide_stream(
        vs, shape, collision=kernel_collision_spec(st),
        bc_specs=[bc_to_spec(bc, vs) for bc in st.boundary_conditions],
        store_dtype=store, shifted=shifted, block=block or tiers.kernel_launch(n, True)[0], interpret=interpret,
    )


@pytest.mark.parametrize("policy", ["FP32FP32", "FP32BF16"])
@pytest.mark.parametrize(
    "vs_cls,collision",
    [(D2Q9, "BGK"), (D2Q9, "KBC"), (D3Q19, "BGK"), (D3Q19, "TRT"), (D3Q27, "BGK"), (D3Q27, "KBC")],
)
def test_kernel_parity_matrix(vs_cls, collision, policy):
    """One kernel step against the jnp tier.  FP32BF16: bf16 deviation
    storage g = f - w on both sides (the jnp step runs in f32 on g + w),
    agreeing to one bf16 ulp of the largest deviation."""
    st, f0, bm, mm = _cavity(vs_cls, collision=collision)
    shape = st.grid.shape
    w = st.velocity_set._w.reshape((-1,) + (1,) * len(shape)).astype(np.float32)
    mask = pack_masks(bm, mm)
    if policy == "FP32FP32":
        out = _kernel(st, shape)(f0, mask, 1.5)
        ref = st(f0, f0, bm, mm, 1.5)[1]
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=0, atol=5e-7)
        return
    g0 = (f0 - w).astype(jnp.bfloat16)
    out = _kernel(st, shape, store=jnp.bfloat16, shifted=True)(g0, mask, 1.5)
    f = g0.astype(jnp.float32) + w
    ref = (st(f, f, bm, mm, 1.5)[1] - w).astype(jnp.bfloat16)
    dev = float(jnp.max(jnp.abs(ref.astype(jnp.float32))))
    ulp = 2.0 ** (np.floor(np.log2(dev)) - 7)
    np.testing.assert_allclose(np.asarray(out, np.float32), np.asarray(ref, np.float32), rtol=0, atol=ulp)


def _periodic(vs_cls, shape):
    vs = init_env(vs_cls)
    grid = grid_factory(shape, mesh_shape=(1,) * len(shape), devices=jax.devices()[:1])
    st = IncompressibleNavierStokesStepper(grid)
    _, _, bm, mm = st.prepare_fields()
    rng = np.random.default_rng(1)
    w = vs._w.reshape((-1,) + (1,) * len(shape))
    f0 = jnp.asarray((w * (1.0 + 0.05 * rng.standard_normal((vs.q,) + shape))).astype(np.float32))
    return st, f0, bm, mm


@pytest.mark.parametrize("block", [8, 64, None])
@pytest.mark.parametrize("vs_cls,shape", [(D3Q19, (7, 5, 3)), (D3Q27, (5, 4, 3)), (D2Q9, (33, 17))])
def test_kernel_masked_tail_and_block_choice(vs_cls, shape, block):
    """Odd extents leave a partial last block (masked at the store); small
    blocks split the domain over many programs.  Two steps match the jnp
    tier whatever the block."""
    st, f0, bm, mm = _periodic(vs_cls, shape)
    assert int(np.prod(shape)) % (block or 1 << 20) != 0 or block is None
    k = _kernel(st, shape, block=block)
    mask = pack_masks(bm, mm)
    out, ref = f0, f0
    for t in range(2):
        out = k(out, mask, 1.3)
        ref = st(ref, ref, bm, mm, 1.3, t)[1]
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=0, atol=5e-7)


@pytest.mark.parametrize("vs_cls", [D2Q9, D3Q19, D3Q27])
def test_kernel_periodic_wrap(vs_cls):
    """With omega = 0 the step is pure streaming: a pulse in every
    direction at the corner cell must wrap across every face exactly like
    ``jnp.roll`` by c_l."""
    shape = _SHAPES[vs_cls]
    st, _, bm, mm = _periodic(vs_cls, shape)
    vs = st.velocity_set
    w = vs._w.reshape((-1,) + (1,) * len(shape)).astype(np.float32)
    f0 = np.broadcast_to(w, (vs.q,) + shape).copy()
    f0[(slice(None),) + (0,) * len(shape)] += 0.01 * (1 + np.arange(vs.q))
    out = np.asarray(_kernel(st, shape, block=16)(jnp.asarray(f0), pack_masks(bm, mm), 0.0))
    ref = np.stack([np.roll(f0[l], tuple(int(c) for c in vs._c[:, l]), axis=tuple(range(len(shape)))) for l in range(vs.q)])
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("n_cells", [1, 5, 4096, 5000, 1 << 20])
def test_kernel_launch_shape(n_cells):
    """Interpret mode takes the smallest power of two covering the domain
    (capped); the GPU takes the tuned fixed shape."""
    block, warps = tiers.kernel_launch(n_cells, interpret=True)
    assert block & (block - 1) == 0 and warps == 4
    assert block >= min(n_cells, tiers._INTERPRET_MAX_BLOCK) and block <= max(tiers._INTERPRET_MAX_BLOCK, 1)
    assert block < 2 * max(n_cells, 1)
    assert tiers.kernel_launch(n_cells, interpret=False) == (tiers.GPU_BLOCK, tiers.GPU_NUM_WARPS)


@pytest.mark.parametrize("bad", ["block", "shape"])
def test_kernel_rejects_bad_launch(bad):
    vs = D3Q19()
    with pytest.raises(ValueError, match="power of two" if bad == "block" else "does not match"):
        if bad == "block":
            build_fused_collide_stream(vs, (4, 4, 4), block=96, interpret=True)
        else:
            build_fused_collide_stream(vs, (4, 4), block=64, interpret=True)


def _rotating_sphere_d3q19():
    from xlb_tpu.boundary import ExtrapolationOutflowBC, HalfwayBounceBackBC

    vs = init_env(D3Q19)
    shape = (12, 8, 8)
    grid = grid_factory(shape, mesh_shape=(1, 1, 1), devices=jax.devices()[:1])
    box_ne = grid.bounding_box_indices(remove_edges=True)
    block = np.stack([a.ravel() for a in np.meshgrid(np.arange(4, 6), np.arange(3, 5), np.arange(3, 5), indexing="ij")])
    center = np.array([5.0, 4.0, 4.0])
    bcs = [
        EquilibriumBC(rho=1.0, u=(0.03, 0.0, 0.0), indices=box_ne["left"]),
        ExtrapolationOutflowBC(indices=box_ne["right"]),
        HalfwayBounceBackBC(
            indices=block.tolist(),
            profile=lambda x: np.cross(np.array([0.0, 0.0, 0.01])[None, :], (x - center[:, None]).T).T,
        ),
    ]
    st = IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs)
    st.prepare_fields()
    return st, shape


@pytest.mark.parametrize(
    "case", ["D2Q9-BGK", "D3Q19-BGK", "D3Q19-BGK-bf16", "D3Q27-KBC", "D3Q19-MRT", "D3Q19-aux-staging"]
)
def test_kernel_lowers_for_cuda(case):
    """The compiled (non-interpret) kernel lowers through Pallas's Triton
    route for CUDA -- the path the GPU compiles -- without a card."""
    if case == "D3Q19-aux-staging":
        st, shape = _rotating_sphere_d3q19()
    else:
        lattice, collision = case.split("-")[:2]
        vs_cls = {"D2Q9": D2Q9, "D3Q19": D3Q19, "D3Q27": D3Q27}[lattice]
        st = _cavity(vs_cls, collision=collision)[0]
        shape = st.grid.shape
    bf16 = case.endswith("bf16")
    store = jnp.bfloat16 if bf16 else jnp.float32
    k = _kernel(st, shape, block=tiers.GPU_BLOCK, store=store, shifted=bf16, interpret=False)
    q = st.velocity_set.q
    args = [jax.ShapeDtypeStruct((q,) + shape, store), jax.ShapeDtypeStruct(shape, jnp.int32), 1.5]
    kwargs = {}
    if k.aux_nchan:
        kwargs["aux"] = jax.ShapeDtypeStruct((k.aux_nchan,) + shape, jnp.float32)
    lowered = jax.jit(k).trace(*args, **kwargs).lower(lowering_platforms=("cuda",))
    assert "triton" in lowered.as_text()
    assert "pallas_triton" in k.active_tier and not k.interpret


@pytest.mark.parametrize("form", ["step", "window"])
@pytest.mark.parametrize("vs_cls", [D2Q9, D3Q19])
def test_custom_vjp_matches_jnp_grad(vs_cls, form):
    """jax.grad through the fused step / window (custom_vjp, backward =
    the jnp tier's VJP) equals jax.grad of the jnp tier."""
    st, f0, bm, mm = _cavity(vs_cls)
    steps = 3
    if form == "step":
        fused = build_fused_step(st, interpret=True)

        def run_fused(f, om):
            for t in range(steps):
                f = fused(f, f, bm, mm, om, t)[1]
            return f
    else:
        win = build_fused_window(st, steps, interpret=True)

        def run_fused(f, om):
            return win(f, f, bm, mm, om)[0]

    def run_jnp(f, om):
        for t in range(steps):
            f = st(f, f, bm, mm, om, t)[1]
        return f

    def loss(run):
        return lambda f, om: jnp.sum(run(f, om) ** 2)

    gf, go = jax.grad(loss(run_fused), argnums=(0, 1))(f0, jnp.float32(1.4))
    jf, jo = jax.grad(loss(run_jnp), argnums=(0, 1))(f0, jnp.float32(1.4))
    np.testing.assert_allclose(np.asarray(gf), np.asarray(jf), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(go), float(jo), rtol=2e-3, atol=1e-5)


@pytest.mark.parametrize("backend", ["cpu", "gpu", "tpu"])
def test_tiers_platform_rules(backend, monkeypatch):
    """Interpret mode on the CPU only, the compiled route on the GPU, and
    any other platform raises."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    if backend == "tpu":
        with pytest.raises(RuntimeError, match="NVIDIA GPU"):
            tiers.kernel_interpret()
        return
    assert tiers.kernel_interpret() == (backend == "cpu")
    assert tiers.fused_by_default() == (backend == "gpu")


@pytest.mark.parametrize("env_set", [True, False])
def test_enable_compile_cache(env_set, monkeypatch, tmp_path):
    """``JAX_COMPILATION_CACHE_DIR`` wins and nothing is set in code;
    otherwise the cache is ``<checkout>/.jax_cache``."""
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env_cache"))
        assert tiers.enable_compile_cache(tmp_path) == str(tmp_path / "env_cache")
        assert calls == []
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = tiers.enable_compile_cache(tmp_path)
        assert path == str(tmp_path / ".jax_cache")
        assert calls == [("jax_compilation_cache_dir", path)]


def test_pallas_stepper_reports_tier():
    """The PALLAS stepper names the Triton kernel it runs; the jnp stepper
    reports ``jnp``."""
    init_env(D3Q19, backend=xlb.ComputeBackend.PALLAS)
    grid = grid_factory((8, 8, 8), mesh_shape=(1, 1, 1), devices=jax.devices()[:1])
    st = IncompressibleNavierStokesStepper(grid)
    assert st.active_tier.startswith("pallas_triton") and "interpret" in st.active_tier
    win = st.build_multi_step(2, donate=False)
    assert win.interpret and win.active_tier == st.active_tier
    st_j = IncompressibleNavierStokesStepper(grid, compute_backend=xlb.ComputeBackend.JAX)
    assert st_j.active_tier == "jnp"
