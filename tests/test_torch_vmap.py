"""The problem axis of kernels B1-B4 and their custom ops under
``torch.func.vmap``.

CPU tests: the plain problem-axis versions against per-problem plain calls
(B1-B3 exactly, B4 within float32 rounding of another summation order),
and each op (``svo::pyramid``, ``svo::gradients``, ``svo::sample_patches``,
``svo::gn_accumulate``) under ``vmap`` with batched and unbatched
arguments and nested, against per-problem calls — with PyTorch's warning
for a per-sample fallback turned into an error, so that an op without a
batching rule fails here.

The ``cuda`` tests (skipped without a card) hold every problem of a
B-problem launch to its one-problem launch bit for bit and to the plain
version; on the card's machine, which has no JAX: ``python -m pytest
--noconftest -m cuda tests/test_torch_vmap.py``.
"""

import warnings

import numpy as np
import pytest
import torch

from stereo_svo_tpu_torch.ops import pyramid
from stereo_svo_tpu_torch.ops.kernels import align_kernel, pyramid_kernel

torch.set_num_threads(1)
B = 3


@pytest.fixture(autouse=True)
def no_vmap_fallback():
    """A per-sample fallback of ``vmap`` is an error in these tests."""
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        yield
    torch._C._functorch._set_vmap_fallback_warning_enabled(False)


def _rng(seed):
    return np.random.default_rng(seed)


def _imgs(seed, *shape):
    return torch.from_numpy(_rng(seed).uniform(0, 255, shape).astype(
        np.float32))


def _centres(seed, lead, M, h, w, margin=-4.0):
    """Centres over the whole level, some beyond its border."""
    r = _rng(seed)
    u = r.uniform(margin, w - 1 - margin, lead + (M,))
    v = r.uniform(margin, h - 1 - margin, lead + (M,))
    return torch.from_numpy(np.stack([u, v], -1).astype(np.float32))


def _gn_args(seed, lead, N=40, P=4, h=48, w=80):
    r = _rng(seed)
    img = _imgs(seed, *lead, h, w)
    uv = _centres(seed + 1, lead, N, h, w, margin=3.0)
    tmpl = torch.from_numpy(r.uniform(0, 255, lead + (N, P * P)).astype(
        np.float32))
    jac = torch.from_numpy(r.normal(0, 1, lead + (N, P * P, 6)).astype(
        np.float32))
    mask = torch.from_numpy((r.uniform(size=lead + (N, P * P)) > 0.3)
                            .astype(np.float32))
    a = torch.from_numpy(r.uniform(0.8, 1.2, lead).astype(np.float32))
    b = torch.from_numpy(r.uniform(-5, 5, lead).astype(np.float32))
    return img, uv, tmpl, jac, mask, a, b


def _gn_scale(img, uv, tmpl, jac, mask, a, b, P=4, k=8.0):
    """(*B,45) sums of the terms' magnitudes of each B4 output (what a
    float32 sum's rounding scales with): the outputs of the same sums
    over |terms|."""
    return align_kernel.gn_accumulate_batched_plain(
        img, uv, tmpl, jac.abs(), mask, P, k, a, b).abs() + _abs_g(
        img, uv, tmpl, jac, mask, a, b, P, k)


def _abs_g(img, uv, tmpl, jac, mask, a, b, P, k):
    """|J|·w·|e| for the g entries (zero elsewhere)."""
    cur = align_kernel.sample_patches_batched_plain(img.unsqueeze(-3), uv,
                                                    P)[..., 0, :, :]
    e = cur - (a[..., None, None] * tmpl + b[..., None, None])
    w = torch.where(e.abs() <= k, torch.ones_like(e),
                    k / torch.clamp(e.abs(), min=1e-6)) * mask
    g = torch.einsum("...npi,...np->...i", jac.abs(), w * e.abs())
    out = torch.zeros(g.shape[:-1] + (45,))
    out[..., 36:42] = g
    return out


def _close_sums(x, y, scale, rtol=1e-6):
    """|x − y| within rtol of each output's sum of term magnitudes."""
    err = torch.abs(x - y) / torch.clamp(scale, min=1e-30)
    assert float(torch.max(err)) <= rtol, float(torch.max(err))


# ---- the plain problem-axis versions ---------------------------------------

@pytest.mark.parametrize("shape,L", [((61, 93), 4), ((13, 40), 5),
                                     ((48, 64), 1)])
def test_pyramid_op_plain_equals_per_problem(shape, L):
    """B1 and B2 over (B,…) frames: each problem exactly its own
    pyramid."""
    img = _imgs(1, B, *shape)
    flat = pyramid_kernel.pyramid_op(img, L)
    for b in range(B):
        assert torch.equal(flat[b], pyramid_kernel.pyramid_op(img[b], L))
        for lv, ref in zip(pyramid_kernel.level_views(flat[b], *shape, L),
                           pyramid_kernel.pyramid_plain(img[b], L)):
            assert torch.equal(lv[0], ref)
            gx, gy = pyramid_kernel.gradients_plain(ref)
            assert torch.equal(lv[1], gx) and torch.equal(lv[2], gy)


def test_gradients_op_plain_equals_per_problem():
    img = _imgs(2, 2, B, 20, 33)
    g = pyramid_kernel.gradients_op(img)
    assert g.shape == (2, B, 2, 20, 33)
    for i in range(2):
        for b in range(B):
            gx, gy = pyramid_kernel.gradients_plain(img[i, b])
            assert torch.equal(g[i, b, 0], gx) and torch.equal(g[i, b, 1], gy)


@pytest.mark.parametrize("K,P", [(1, 4), (3, 4), (3, 8), (1, 16)])
def test_sample_patches_batched_plain_equals_per_problem(K, P):
    img = _imgs(3, B, K, 40, 70)
    uv = _centres(4, (B,), 25, 40, 70)
    out = align_kernel.sample_patches_batched_plain(img, uv, P)
    assert out.shape == (B, K, 25, P * P)
    for b in range(B):
        assert torch.equal(out[b], align_kernel.sample_patches_plain(
            img[b], uv[b], P))


def test_gn_accumulate_batched_plain_within_rounding():
    """B4's plain problem axis sums the same terms as the per-problem
    plain version in another order: within 1e-6 of each sum's term
    magnitudes (float32 rounding); the counts exact."""
    img, uv, tmpl, jac, mask, a, b = _gn_args(5, (B,))
    out = align_kernel.gn_accumulate_batched_plain(img, uv, tmpl, jac, mask,
                                                   4, 8.0, a, b)
    assert out.shape == (B, 45)
    scale = _gn_scale(img, uv, tmpl, jac, mask, a, b)
    for i in range(B):
        one = align_kernel.gn_accumulate_batched_plain(
            img[i], uv[i], tmpl[i], jac[i], mask[i], 4, 8.0, a[i], b[i])
        _close_sums(out[i], one, scale[i])
        assert torch.equal(out[i, 43:], one[43:])


# ---- the custom ops under vmap ----------------------------------------------

def test_pyramid_under_vmap_and_nested():
    img = _imgs(6, 2, B, 30, 52)
    inner = torch.func.vmap(lambda im: pyramid.build_with_gradients(im, 3))
    levels, gxs, gys = torch.func.vmap(inner)(img)
    for i in range(2):
        for b in range(B):
            ref = pyramid.build_with_gradients(img[i, b], 3)
            for got, want in zip(levels + gxs + gys, sum(ref, ())):
                assert torch.equal(got[i, b], want)


def test_gradients_under_vmap():
    img = _imgs(7, B, 20, 30)
    gx, gy = torch.func.vmap(pyramid_kernel.gradients)(img)
    for b in range(B):
        rx, ry = pyramid_kernel.gradients(img[b])
        assert torch.equal(gx[b], rx) and torch.equal(gy[b], ry)


@pytest.mark.parametrize("in_dims", [(0, 0), (None, 0), (0, None), (1, 0)])
def test_sample_patches_under_vmap(in_dims):
    """Batched and shared images and centres, the batch on any dim."""
    img = _imgs(8, B, 3, 40, 70)
    uv = _centres(9, (B,), 30, 40, 70)
    img_in = img[0] if in_dims[0] is None else (
        img.movedim(0, 1) if in_dims[0] == 1 else img)
    uv_in = uv[0] if in_dims[1] is None else uv
    out = torch.func.vmap(lambda im, u: align_kernel.sample_patches(im, u, 8),
                          in_dims=in_dims)(img_in, uv_in)
    for b in range(B):
        im = img[0] if in_dims[0] is None else img[b]
        u = uv[0] if in_dims[1] is None else uv[b]
        assert torch.equal(out[b], align_kernel.sample_patches(im, u, 8))


def test_sample_patches_under_nested_vmap():
    """Sequences × edges, as the online loop inside the batched step: one
    problem for each pair, a 2-D image (K = 1)."""
    img = _imgs(10, B, 40, 70)
    uv = _centres(11, (B, 2), 30, 40, 70)
    inner = torch.func.vmap(lambda im, u: align_kernel.sample_patches(
        im, u, 4), in_dims=(None, 0))
    out = torch.func.vmap(inner)(img, uv)
    assert out.shape == (B, 2, 30, 16)
    for b in range(B):
        for e in range(2):
            assert torch.equal(out[b, e], align_kernel.sample_patches(
                img[b], uv[b, e], 4))


def test_gn_accumulate_under_vmap_shared_template():
    """The images and centres batched, the template, Jacobians, mask and
    illumination shared (expanded, not copied); and nested."""
    img, uv, tmpl, jac, mask, a, b = _gn_args(12, (B,))

    def one(im, u):
        return torch.cat([x.reshape(-1) for x in align_kernel.gn_accumulate(
            im, u, tmpl[0], jac[0], mask[0], 4, 8.0, a[0], b[0])])
    out = torch.func.vmap(one)(img, uv)
    nested = torch.func.vmap(torch.func.vmap(one))(
        img[None].expand(2, *img.shape), uv[None].expand(2, *uv.shape))
    for i in range(B):
        want = one(img[i], uv[i])
        scale = _gn_scale(img[i], uv[i], tmpl[0], jac[0], mask[0], a[0],
                          b[0])
        _close_sums(out[i], want, scale)
        _close_sums(nested[1, i], want, scale)


def test_gn_accumulate_under_vmap_per_feature_mask():
    """A per-feature (N,) mask, broadcast over the patch inside vmap."""
    img, uv, tmpl, jac, _, a, b = _gn_args(13, (B,))
    feat = torch.from_numpy((_rng(14).uniform(size=(B, uv.shape[1])) > 0.4)
                            .astype(np.float32))
    out = torch.func.vmap(lambda *x: align_kernel.gn_accumulate(
        *x[:4], x[4], 4, 8.0, *x[5:])[0])(img, uv, tmpl, jac, feat, a, b)
    full = feat[..., None].expand(tmpl.shape)
    for i in range(B):
        want = align_kernel.gn_accumulate(img[i], uv[i], tmpl[i], jac[i],
                                          feat[i], 4, 8.0, a[i], b[i])[0]
        scale = _gn_scale(img[i], uv[i], tmpl[i], jac[i], full[i], a[i],
                          b[i])[:36].reshape(6, 6)
        _close_sums(out[i], want, scale)


def test_ops_have_fake_kernels():
    """Each op's fake (meta) kernel gives its output shape."""
    m = torch.empty((B, 3, 40, 70), device="meta")
    uv = torch.empty((B, 30, 2), device="meta")
    assert align_kernel.sample_patches_op(m, uv, 8).shape == (B, 3, 30, 64)
    assert pyramid_kernel.gradients_op(m[:, 0]).shape == (B, 2, 40, 70)
    total, _, _ = pyramid_kernel._layout(40, 70, 3)
    assert pyramid_kernel.pyramid_op(m[:, 0], 3).shape == (B, total)
    args = [torch.empty(s, device="meta") for s in
            ((B, 40, 70), (B, 30, 2), (B, 30, 16), (B, 30, 16, 6),
             (B, 30, 16))]
    ab = torch.empty((B,), device="meta")
    assert align_kernel.gn_accumulate_op(*args, 4, 8.0, ab, ab).shape == (B,
                                                                         45)


# ---- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _cuda(x, device):
    return x.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,L", [((480, 752), 4), ((376, 1241), 4),
                                     ((61, 93), 8)])
def test_cuda_pyramid_problem_axis(cuda_device, shape, L):
    """B1 and B2 over 8 frames: each problem bit for bit its one-frame
    launch and the plain version; one B1 launch (per 6 levels) and one B2
    launch (every level) for all of them."""
    img = _cuda(_imgs(20, 8, *shape), cuda_device)
    before = dict(pyramid_kernel.LAUNCHES)
    flat = pyramid_kernel.pyramid_op(img, L)
    torch.cuda.synchronize()
    _, _, launches = pyramid_kernel._layout(*shape, L)
    assert pyramid_kernel.LAUNCHES["halfsample"] == (before["halfsample"]
                                                     + launches)
    assert pyramid_kernel.LAUNCHES["gradients"] == before["gradients"] + 1
    for b in range(8):
        assert torch.equal(flat[b], pyramid_kernel.pyramid_op(img[b], L))
        assert torch.equal(flat[b].cpu(), pyramid_kernel.pyramid_op(
            img[b].cpu(), L))


@pytest.mark.cuda
@pytest.mark.parametrize("K,P,N", [(3, 4, 192), (1, 8, 192), (1, 4, 192),
                                   (3, 8, 192), (1, 16, 192), (1, 8, 3840)])
def test_cuda_sample_patches_problem_axis(cuda_device, K, P, N):
    img = _cuda(_imgs(21, 8, K, 240, 376), cuda_device)
    uv = _cuda(_centres(22, (8,), N, 240, 376), cuda_device)
    out = align_kernel.sample_patches_op(img, uv, P)
    torch.cuda.synchronize()
    for b in range(8):
        one = align_kernel.sample_patches_op(img[b], uv[b], P)
        assert torch.equal(out[b], one)
        assert torch.equal(one.cpu(), align_kernel.sample_patches_plain(
            img[b].cpu(), uv[b].cpu(), P))


@pytest.mark.cuda
@pytest.mark.parametrize("N", [192, 2048])
def test_cuda_gn_accumulate_problem_axis(cuda_device, N):
    """B4 over 8 problems (and 64, sequences × edges): each bit for bit its
    one-problem launch, within 1e-6 of each sum's term magnitudes of the
    plain version (sums of N·16 terms in another order), the counts
    exact."""
    args = [_cuda(x, cuda_device) for x in _gn_args(23, (8,), N=N, h=240,
                                                     w=376)]
    out = align_kernel.gn_accumulate_op(*args[:5], 4, 8.0, *args[5:])
    wide = torch.func.vmap(torch.func.vmap(
        lambda *x: align_kernel.gn_accumulate_op(*x[:5], 4, 8.0, *x[5:])))(
        *(x[None].expand(8, *x.shape) for x in args))
    torch.cuda.synchronize()
    for b in range(8):
        one = align_kernel.gn_accumulate_op(*(x[b] for x in args[:5]), 4,
                                            8.0, *(x[b] for x in args[5:]))
        assert torch.equal(out[b], one) and torch.equal(wide[3, b], one)
        cpu = [x[b].cpu() for x in args]
        plain = align_kernel.gn_accumulate_batched_plain(*cpu[:5], 4, 8.0,
                                                         *cpu[5:])
        _close_sums(one.cpu(), plain, _gn_scale(*cpu))
        assert torch.equal(one[43:].cpu(), plain[43:])
