"""The port's kernels B1-B4: plain PyTorch versions against the JAX
reference (XLA path and the Pallas kernels in interpret mode), and the CUDA
kernels against their plain versions (``cuda`` marker: skipped without a
card).
"""

import numpy as np
import pytest
import torch

from stereo_svo_tpu_torch.ops import pyramid
from stereo_svo_tpu_torch.ops.kernels import align_kernel, pyramid_kernel

try:
    import jax
    import jax.numpy as jnp

    from stereo_svo_tpu.ops import interp as jinterp
    from stereo_svo_tpu.ops import pyramid as jpyramid
    from stereo_svo_tpu.ops.pallas import align_kernel as pallas_align
    from stereo_svo_tpu.ops.pallas import pyramid_kernel as pallas_pyr
    INTERPRET = jax.default_backend() != "tpu"
except ImportError:
    # the card's machine has no JAX: there only the ``cuda`` tests run,
    # with ``pytest --noconftest -m cuda tests/test_torch_kernels.py``
    jax = None


def _img(seed, h=64, w=256):
    return np.random.default_rng(seed).uniform(0, 255, (h, w)).astype(
        np.float32)


def _t(a, device="cpu"):
    return torch.from_numpy(np.array(a)).to(device)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


# ---- B1 / B2: pyramid -------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 256), (61, 93)])
def test_halfsample_plain_matches_reference(shape):
    img = _img(1, *shape)
    ours = pyramid_kernel.halfsample_plain(_t(img)).numpy()
    # summation order of the 2x2 mean may differ by one ulp of 255
    np.testing.assert_allclose(
        ours, np.asarray(jpyramid.halfsample(jnp.asarray(img))), atol=3e-5)
    if shape[0] % 16 == 0:
        np.testing.assert_allclose(
            ours, np.asarray(pallas_pyr.halfsample(jnp.asarray(img),
                                                   interpret=INTERPRET)),
            atol=3e-5)


@pytest.mark.parametrize("shape", [(64, 256), (7, 5)])
def test_gradients_plain_matches_reference(shape):
    img = _img(2, *shape)
    gx, gy = pyramid_kernel.gradients_plain(_t(img))
    for ours, ref in zip((gx, gy), jpyramid.gradients(jnp.asarray(img))):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    for ours, ref in zip((gx, gy), pallas_pyr.gradients(
            jnp.asarray(img), interpret=INTERPRET)):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


# ---- B3: patch sampling -----------------------------------------------------

def _border_centres(h, w, n, seed):
    """Centres within 2 px of every border and beyond it (W1)."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-3.0, w + 2.0, n)
    v = rng.uniform(-3.0, h + 2.0, n)
    side = rng.integers(0, 4, n)
    u = np.where(side == 0, rng.uniform(-3.0, 2.0, n), u)
    u = np.where(side == 1, rng.uniform(w - 3.0, w + 2.0, n), u)
    v = np.where(side == 2, rng.uniform(-3.0, 2.0, n), v)
    v = np.where(side == 3, rng.uniform(h - 3.0, h + 2.0, n), v)
    return np.stack([u, v], -1).astype(np.float32)


@pytest.mark.parametrize("P", [4, 8])
def test_sample_patches_plain_matches_interp_at_borders(P):
    img = _img(3)
    uv = _border_centres(64, 256, 96, seed=P)
    ours = align_kernel.sample_patches_plain(_t(img), _t(uv), P).numpy()
    ref = np.asarray(jinterp.sample_patch(jnp.asarray(img), jnp.asarray(uv),
                                          P, method="gather"))
    # the same tap formula on both sides; only XLA's fusion may round a
    # product differently
    np.testing.assert_allclose(ours, ref, atol=1e-4)


@pytest.mark.parametrize("P", [4, 8])
def test_sample_patches_plain_matches_pallas_interior(P):
    """At interior centres the Pallas centre-clamp rule agrees with the
    per-tap rule the port follows."""
    rng = np.random.default_rng(4)
    img = _img(4)
    uv = np.stack([rng.uniform(8, 248, 32), rng.uniform(8, 56, 32)],
                  -1).astype(np.float32)
    ours = align_kernel.sample_patches_plain(_t(img), _t(uv), P).numpy()
    ref = np.asarray(pallas_align.sample_patches(
        jnp.asarray(img), jnp.asarray(uv), P, interpret=INTERPRET))
    # the Pallas blend uses four products per tap instead of two lerps
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=2e-3)


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("P", [4, 8, 16])
def test_sample_patches_plain_stacked_planes(K, P):
    """A (K,H,W) input samples every plane at the same centres: each plane
    equals its own single-image call bit for bit, the JAX gather sampler at
    border centres and (P ≤ 8: the Pallas window is 16 rows) the Pallas
    kernel at interior centres."""
    rng = np.random.default_rng(20 + K + P)
    imgs = np.stack([_img(30 + k) for k in range(K)])
    edge = _border_centres(64, 256, 48, seed=P)
    inner = np.stack([rng.uniform(P + 2, 256 - P - 2, 48),
                      rng.uniform(P + 2, 64 - P - 2, 48)], -1)
    uv = np.concatenate([edge, inner]).astype(np.float32).reshape(8, 12, 2)
    out = align_kernel.sample_patches_plain(_t(imgs), _t(uv), P)
    assert out.shape == (K, 8, 12, P * P)
    for k in range(K):
        single = align_kernel.sample_patches_plain(_t(imgs[k]), _t(uv), P)
        assert torch.equal(out[k], single)
        ref = np.asarray(jinterp.sample_patch(
            jnp.asarray(imgs[k]), jnp.asarray(uv.reshape(-1, 2)), P,
            method="gather")).reshape(8, 12, P * P)
        np.testing.assert_allclose(out[k].numpy(), ref, atol=1e-4)
        if P <= 8:
            pallas = np.asarray(pallas_align.sample_patches(
                jnp.asarray(imgs[k]), jnp.asarray(inner.astype(np.float32)),
                P, interpret=INTERPRET))
            np.testing.assert_allclose(out[k].reshape(96, -1)[48:].numpy(),
                                       pallas, rtol=1e-5, atol=2e-3)
    # the wrapper takes the plain version on the CPU, stacked too
    assert torch.equal(align_kernel.sample_patches(_t(imgs), _t(uv), P), out)


@pytest.mark.parametrize("shape,L", [
    ((61, 93), 3), ((61, 93), 4), ((61, 93), 5),
    ((13, 40), 5),       # 13 → 6 → 3 → 1 → 0 rows: the deepest level empty
    ((61, 93), 1)])      # level 0 only
def test_pyramid_levels_share_one_buffer_per_level(shape, L):
    """pyramid_plain and build_with_gradients match the JAX pyramid; every
    level's image, gx and gy lie in one (3,h,w) buffer, the buffers one
    after another in one allocation, and level_planes hands B3 a view."""
    img = _img(40, *shape)
    jl, jgx, jgy = jpyramid.build_with_gradients(jnp.asarray(img), L)
    plain = pyramid_kernel.pyramid_plain(_t(img), L)
    levels, gxs, gys = pyramid.build_with_gradients(_t(img), L)
    assert len(plain) == len(levels) == L
    assert torch.equal(levels[0], _t(img))
    storage = levels[0].untyped_storage().data_ptr()
    for lv in range(L):
        assert levels[lv].shape == jl[lv].shape
        # JAX's mean sums the 2x2 block in its own order
        np.testing.assert_allclose(plain[lv].numpy(), np.asarray(jl[lv]),
                                   atol=3e-5)
        assert torch.equal(levels[lv], plain[lv])
        np.testing.assert_allclose(gxs[lv].numpy(), np.asarray(jgx[lv]),
                                   atol=3e-5)
        np.testing.assert_allclose(gys[lv].numpy(), np.asarray(jgy[lv]),
                                   atol=3e-5)
        for t in (levels[lv], gxs[lv], gys[lv]):
            assert t.untyped_storage().data_ptr() == storage
        if levels[lv].numel() == 0:
            continue
        planes = pyramid.level_planes(levels[lv], gxs[lv], gys[lv])
        assert planes.data_ptr() == levels[lv].data_ptr()   # a view
        assert torch.equal(planes, torch.stack([levels[lv], gxs[lv],
                                                gys[lv]]))
        if lv + 1 < L and levels[lv + 1].numel():
            # the next level's buffer starts where this one's gy ends
            assert levels[lv + 1].data_ptr() == (
                gys[lv].data_ptr() + gys[lv].numel() * 4)
    if L < 2:
        return
    # maps built apart are stacked (a copy)
    apart = pyramid.level_planes(levels[1].clone(), gxs[1], gys[1])
    assert torch.equal(apart, pyramid.level_planes(levels[1], gxs[1],
                                                   gys[1]))


# ---- B4: fused Gauss-Newton accumulation ------------------------------------

def _gn_inputs(seed, N=48, P=4):
    rng = np.random.default_rng(seed)
    img = _img(seed)
    uv = np.stack([rng.uniform(8, 248, N), rng.uniform(8, 56, N)],
                  -1).astype(np.float32)
    tmpl = rng.uniform(0, 255, (N, P * P)).astype(np.float32)
    jac = rng.normal(0, 1, (N, P * P, 6)).astype(np.float32)
    return img, uv, tmpl, jac


def test_gn_accumulate_plain_matches_pallas():
    """Per-feature weight and (a, b) = (1.3, −7), the Pallas signature."""
    P, k, a_il, b_il = 4, 8.0, 1.3, -7.0
    img, uv, tmpl, jac = _gn_inputs(5)
    w = (np.random.default_rng(6).uniform(size=48) > 0.25).astype(np.float32)
    H, g, cost, n_eff, _ = align_kernel.gn_accumulate_plain(
        _t(img), _t(uv), _t(tmpl), _t(jac), _t(w), P, k,
        torch.tensor(a_il), torch.tensor(b_il))
    jH, jg, jcost, jn = pallas_align.gn_accumulate(
        jnp.asarray(img), jnp.asarray(uv), jnp.asarray(tmpl),
        jnp.asarray(jac), jnp.asarray(w), P, k, a_il=a_il, b_il=b_il,
        interpret=INTERPRET)
    # float32 sums of 768 terms in two different orders
    np.testing.assert_allclose(H.numpy(), np.asarray(jH), rtol=2e-4, atol=5e-3)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=2e-4, atol=5e-2)
    np.testing.assert_allclose(float(cost), float(jcost), rtol=1e-4)
    # Pallas counts features, the port counts pixels (Σ of the (N,P²) mask)
    assert float(n_eff) == P * P * float(jn)


def _gn_oracle(img, uv, tmpl, jac, mask, P, k, a_il, b_il):
    cur = np.asarray(jinterp.sample_patch(jnp.asarray(img), jnp.asarray(uv),
                                          P, method="gather"), np.float64)
    e = cur - (a_il * tmpl.astype(np.float64) + b_il)
    a = np.abs(e)
    w = np.where(a <= k, 1.0, k / np.maximum(a, 1e-6)) * mask
    J = jac.astype(np.float64)
    return (np.einsum("npi,np,npj->ij", J, w, J),
            np.einsum("npi,np,np->i", J, w, e), np.sum(w * e * e),
            np.sum(mask), np.sum((a < k) * mask))


def _pixel_mask(seed, N=48, P=4):
    return (np.random.default_rng(seed).uniform(size=(N, P * P))
            > 0.3).astype(np.float32)


def test_gn_accumulate_plain_matches_f64_oracle():
    """Per-pixel mask, as the refresh pass of align passes it, including
    the inlier count."""
    P, k, a_il, b_il = 4, 8.0, 0.9, 4.0
    img, uv, tmpl, jac = _gn_inputs(7)
    # templates near the samples, so that the Huber threshold splits them
    cur = np.asarray(jinterp.sample_patch(jnp.asarray(img), jnp.asarray(uv),
                                          P, method="gather"))
    tmpl = ((cur - b_il) / a_il + np.random.default_rng(8).normal(
        0, 8, cur.shape)).astype(np.float32)
    mask = _pixel_mask(9)
    out = align_kernel.gn_accumulate_plain(
        _t(img), _t(uv), _t(tmpl), _t(jac), _t(mask), P, k,
        torch.tensor(a_il), torch.tensor(b_il))
    H_o, g_o, cost_o, n_o, inl_o = _gn_oracle(img, uv, tmpl, jac, mask, P,
                                              k, a_il, b_il)
    np.testing.assert_allclose(out[0].numpy(), H_o, rtol=2e-4, atol=5e-3)
    np.testing.assert_allclose(out[1].numpy(), g_o, rtol=2e-4, atol=5e-2)
    np.testing.assert_allclose(float(out[2]), cost_o, rtol=1e-4)
    assert float(out[3]) == n_o
    assert float(out[4]) == inl_o
    assert 0 < inl_o < n_o


def test_kernel_wrappers_raise_off_cpu_and_cuda():
    """No silent fallback: a tensor that is neither on the CPU nor on a
    CUDA device (or a mix of devices) raises."""
    img = torch.empty((8, 8), device="meta")
    uv = torch.empty((4, 2), device="meta")
    with pytest.raises(ValueError):
        align_kernel.sample_patches(img, uv, 4)
    with pytest.raises(ValueError):
        pyramid_kernel.halfsample(img)
    with pytest.raises(ValueError):
        pyramid_kernel.pyramid(img, 4)
    with pytest.raises(ValueError):
        pyramid_kernel.pyramid(torch.zeros(8, 8), 0)
    with pytest.raises(ValueError):
        align_kernel.sample_patches(torch.zeros(8, 8), uv, 4)


# ---- CUDA kernels against their plain versions ------------------------------

@pytest.mark.cuda
def test_cuda_pyramid_kernels(cuda_device):
    img = _t(_img(10, 480, 752), cuda_device)
    before = dict(pyramid_kernel.LAUNCHES)
    half = pyramid_kernel.halfsample(img)
    into = torch.full((240, 376), float("nan"), device=cuda_device)
    pyramid_kernel.halfsample(img, out=into)
    gx, gy = pyramid_kernel.gradients(img)
    torch.cuda.synchronize()
    assert pyramid_kernel.LAUNCHES["halfsample"] == before["halfsample"] + 2
    assert pyramid_kernel.LAUNCHES["gradients"] == before["gradients"] + 1
    # same additions in the same order, no fused multiply-add: exact
    torch.testing.assert_close(half, pyramid_kernel.halfsample_plain(img),
                               rtol=0, atol=0)
    assert torch.equal(into, half)
    pgx, pgy = pyramid_kernel.gradients_plain(img)
    torch.testing.assert_close(gx, pgx, rtol=0, atol=0)
    torch.testing.assert_close(gy, pgy, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("P", [4, 8])
def test_cuda_sample_patches(cuda_device, P):
    img = _t(_img(11, 480, 752), cuda_device)
    uv = _t(np.concatenate([_border_centres(480, 752, 96, seed=P),
                            _border_centres(480, 752, 96, seed=P + 1) * 0.5
                            + 100.0]), cuda_device)
    ours = align_kernel.sample_patches(img, uv, P)
    torch.testing.assert_close(
        ours, align_kernel.sample_patches_plain(img, uv, P),
        rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [192, 240, 2048, 4096])
def test_cuda_gn_accumulate(cuda_device, N):
    """Main-path (192), KITTI (240) and stress (2048) widths: 12, 15 and
    128 blocks; 4096 runs past the 128-block cap (grid-stride)."""
    P, k = 4, 8.0
    img, uv, tmpl, jac = _gn_inputs(12, N=N)
    args = [_t(a, cuda_device) for a in (img, uv, tmpl, jac,
                                         _pixel_mask(13, N=N))]
    ab = (torch.tensor(1.3, device=cuda_device),
          torch.tensor(-7.0, device=cuda_device))
    ours = align_kernel.gn_accumulate(*args, P, k, *ab)
    plain = align_kernel.gn_accumulate_plain(*args, P, k, *ab)
    # float32 sums of N·16 terms in two different orders
    torch.testing.assert_close(ours[0], plain[0], rtol=1e-4, atol=1e-2)
    torch.testing.assert_close(ours[1], plain[1], rtol=1e-4, atol=1e-1)
    torch.testing.assert_close(ours[2], plain[2], rtol=1e-4, atol=0)
    torch.testing.assert_close(ours[3:], plain[3:], rtol=0, atol=0)
    again = align_kernel.gn_accumulate(*args, P, k, *ab)
    for a, b in zip(ours, again):           # no atomics: bit for bit
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(376, 1241), (188, 620), (94, 310),
                                   (47, 155), (30, 47), (120, 188)])
def test_cuda_pyramid_kernels_odd_shapes(cuda_device, shape):
    """The KITTI pyramid (1241 wide, then 620, 310, 155; odd trailing
    columns dropped), the stress pyramid's level 4 (47×30) and the
    752×480 keyframe thumbnail (120×188, loop-edge measurement): exact."""
    img = _t(_img(14, *shape), cuda_device)
    half = pyramid_kernel.halfsample(img)
    assert half.shape == (shape[0] // 2, shape[1] // 2)
    torch.testing.assert_close(half, pyramid_kernel.halfsample_plain(img),
                               rtol=0, atol=0)
    for ours, plain in zip(pyramid_kernel.gradients(img),
                           pyramid_kernel.gradients_plain(img)):
        torch.testing.assert_close(ours, plain, rtol=0, atol=0)


# (frame, levels, B1 launches): chip_smoke.py phase 2's three pyramids, a
# width ≡ 1 (mod 4) with odd sizes, an empty deepest level (20 → 10 → 5 →
# 2 → 1 → 0 rows), a pyramid deeper than one launch builds, level 0 alone
CUDA_PYRAMIDS = [((480, 752), 4, 1), ((480, 752), 5, 1), ((376, 1241), 4, 1),
                 ((61, 93), 5, 1), ((20, 70), 6, 1), ((200, 300), 8, 2),
                 ((70, 130), 1, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,L,launches", CUDA_PYRAMIDS)
def test_cuda_pyramid_exact(cuda_device, shape, L, launches):
    """B1 writes every level's image plane bit for bit as the chain of
    halfsample_plain calls, level 0 equal to the frame."""
    img = _t(_img(16, *shape), cuda_device)
    before = pyramid_kernel.LAUNCHES["halfsample"]
    bufs = pyramid_kernel.pyramid(img, L)
    torch.cuda.synchronize()
    assert pyramid_kernel.LAUNCHES["halfsample"] == before + launches
    assert torch.equal(bufs[0][0], img)
    plain = pyramid_kernel.pyramid_plain(img, L)
    assert len(bufs) == len(plain) == L
    for b, ref in zip(bufs, plain):
        assert torch.equal(b[0], ref)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [4, 5])
def test_cuda_build_with_gradients_one_b1_launch(cuda_device, L):
    """One B1 launch per pyramid, one B2 launch per level, nothing else (no
    copy of level 0) in a profiler trace; every map exact."""
    from torch.profiler import ProfilerActivity, profile
    img = _t(_img(17, 480, 752), cuda_device)
    pyramid.build_with_gradients(img, L)            # build, warm up
    torch.cuda.synchronize()
    before = dict(pyramid_kernel.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        levels, gxs, gys = pyramid.build_with_gradients(img, L)
        torch.cuda.synchronize()
    assert pyramid_kernel.LAUNCHES["halfsample"] == before["halfsample"] + 1
    assert pyramid_kernel.LAUNCHES["gradients"] == before["gradients"] + L
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == L + 1, names
    assert sum("pyramid_levels_kernel" in n for n in names) == 1, names
    assert sum("gradients_kernel" in n for n in names) == L, names
    for lv, ref in enumerate(pyramid_kernel.pyramid_plain(img, L)):
        assert torch.equal(levels[lv], ref)
        pgx, pgy = pyramid_kernel.gradients_plain(ref)
        assert torch.equal(gxs[lv], pgx) and torch.equal(gys[lv], pgy)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,N,P", [
    ((188, 620), 3840, 8),      # epipolar probes: 240 seeds × 16 samples
    ((480, 752), 192, 16),      # oversized affine-KLT templates
    ((376, 1241), 240, 8),      # KITTI: 240 features, KLT level 0
    ((240, 376), 2048, 8)])     # stress: 2048 features, KLT level 1
def test_cuda_sample_patches_new_shapes(cuda_device, shape, N, P):
    h, w = shape
    rng = np.random.default_rng(N + P)
    uv = np.stack([rng.uniform(-3.0, w + 2.0, N), rng.uniform(-3.0, h + 2.0, N)],
                  -1).astype(np.float32)
    img = _t(_img(15, h, w), cuda_device)
    uv = _t(uv, cuda_device)
    torch.testing.assert_close(
        align_kernel.sample_patches(img, uv, P),
        align_kernel.sample_patches_plain(img, uv, P), rtol=0, atol=1e-4)


# chip_smoke.py phase 2's B3 shapes: (image h, w), centres, P, planes
PHASE2_B3 = [((480, 752), 192, 8, 1),     # KLT, every iteration
             ((480, 752), 192, 4, 1),     # alignment passes
             ((480, 752), 192, 4, 3),     # alignment template: img, gx, gy
             ((480, 752), 192, 8, 3),     # KLT template on keyframes
             ((188, 620), 3840, 8, 1),    # epipolar probes
             ((480, 752), 192, 16, 1),    # oversized affine-KLT templates
             ((376, 1241), 240, 8, 1),    # KITTI KLT
             ((480, 752), 2048, 8, 1),    # stress KLT
             ((120, 188), 192, 4, 3),     # loop edges: thumbnail template
             ((120, 188), 192, 4, 1),     # loop edges: inner passes
             ((94, 310), 240, 4, 3)]      # KITTI thumbnail template


def _hazard_centres(h, w, P, n, seed):
    """Centres whose first tap sits one rounding step from an integer near
    a power of two (u = c + offset may round onto the next pixel), then
    border centres, then interior ones: n in all."""
    rng = np.random.default_rng(seed)
    near = []
    for b in (32, 64, 128, 256, 512, 1024):
        c = np.float32(b) + np.float32((P - 1) / 2.0)
        for x in (np.nextafter(c, np.float32(0)), c,
                  np.nextafter(c, np.float32(4096))):
            if b + P + 2 < w:
                near.append([x, h / 2.0])
            if b + P + 2 < h:
                near.append([w / 2.0, x])
    inner = np.stack([rng.uniform(0, w - 1, n), rng.uniform(0, h - 1, n)],
                     -1)
    return np.concatenate([np.asarray(near), _border_centres(h, w, n // 4,
                                                             seed),
                           inner])[:n].astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,N,P,K", PHASE2_B3)
def test_cuda_sample_patches_stacked_exact(cuda_device, shape, N, P, K):
    """B3 at every phase-2 shape, one to three planes per launch: bit for
    bit the plain version, border and rounding-hazard centres included."""
    h, w = shape
    imgs = _t(np.stack([_img(50 + k, h, w) for k in range(K)]), cuda_device)
    img = imgs if K > 1 else imgs[0]
    uv = _t(_hazard_centres(h, w, P, N, seed=N + P), cuda_device)
    before = align_kernel.LAUNCHES["sample_patches"]
    ours = align_kernel.sample_patches(img, uv, P)
    torch.cuda.synchronize()
    assert align_kernel.LAUNCHES["sample_patches"] == before + 1
    assert torch.equal(ours, align_kernel.sample_patches_plain(img, uv, P))


def _gn_args(N, device, seed=12):
    img, uv, tmpl, jac = _gn_inputs(seed, N=N)
    return [_t(a, device) for a in (img, uv, tmpl, jac,
                                     _pixel_mask(seed + 1, N=N))]


@pytest.mark.cuda
def test_cuda_gn_accumulate_repeats_across_widths(cuda_device):
    """Back-to-back calls at N = 192, 2048, 192, 2048 on one stream: each
    repeats its first result bit for bit (the ticket counter is back at 0
    after every call, whatever the grid of the call before)."""
    ab = (torch.tensor(1.3, device=cuda_device),
          torch.tensor(-7.0, device=cuda_device))
    args = {N: _gn_args(N, cuda_device) for N in (192, 2048)}
    outs = [align_kernel.gn_accumulate(*args[N], 4, 8.0, *ab)
            for N in (192, 2048, 192, 2048)]
    torch.cuda.synchronize()
    for first, again in ((outs[0], outs[2]), (outs[1], outs[3])):
        assert all(torch.equal(a, b) for a, b in zip(first, again))
    fresh = align_kernel.gn_accumulate(*args[192], 4, 8.0, *ab)
    assert all(torch.equal(a, b) for a, b in zip(outs[0], fresh))


@pytest.mark.cuda
def test_cuda_gn_accumulate_is_one_launch(cuda_device):
    """One CUDA kernel per call in a profiler trace."""
    from torch.profiler import ProfilerActivity, profile
    ab = (torch.tensor(1.3, device=cuda_device),
          torch.tensor(-7.0, device=cuda_device))
    args = _gn_args(192, cuda_device)
    align_kernel.gn_accumulate(*args, 4, 8.0, *ab)     # scratch, warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            align_kernel.gn_accumulate(*args, 4, 8.0, *ab)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 3, kernels
    assert all("gn_accumulate_kernel" in k for k in kernels), kernels


@pytest.mark.cuda
@pytest.mark.parametrize("shape,N", [((120, 188), 192), ((94, 310), 240)])
def test_cuda_gn_accumulate_thumbnail(cuda_device, shape, N):
    """B4 at the keyframe thumbnails of loop-edge measurement (752×480 and
    KITTI), P = loop_patch = 4: counts exact, H, g and cost within 4e-7 of
    each output's largest entry, bit-reproducible."""
    P, k = 4, 8.0
    h, w = shape
    rng = np.random.default_rng(N)
    img = _t(_img(16, h, w), cuda_device)
    uv = _t(np.stack([rng.uniform(2, w - 3, N), rng.uniform(2, h - 3, N)],
                     -1).astype(np.float32), cuda_device)
    tmpl = _t(rng.uniform(0, 255, (N, P * P)).astype(np.float32), cuda_device)
    jac = _t(rng.normal(0, 1, (N, P * P, 6)).astype(np.float32), cuda_device)
    mask = _t(_pixel_mask(17, N=N), cuda_device)
    ab = (torch.tensor(1.3, device=cuda_device),
          torch.tensor(-7.0, device=cuda_device))
    args = (img, uv, tmpl, jac, mask, P, k, *ab)
    ours = align_kernel.gn_accumulate(*args)
    plain = align_kernel.gn_accumulate_plain(*args)
    for a, b in zip(ours[:3], plain[:3]):
        err = float(torch.max(torch.abs(a - b)))
        assert err <= 4e-7 * float(torch.max(torch.abs(b))), err
    torch.testing.assert_close(ours[3:], plain[3:], rtol=0, atol=0)
    again = align_kernel.gn_accumulate(*args)
    assert all(torch.equal(a, b) for a, b in zip(ours, again))
