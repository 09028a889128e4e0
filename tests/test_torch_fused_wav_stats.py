"""K3's two reductions, held on the CPU: the InstanceNorm statistics kernel
(``wav_stats_kernel``) through a written-out emulation of its arithmetic
(``wav_stats_emulation.py``) and its cluster geometry, and the reduce
kernel (``wav_reduce_kernel``) through its grouping, which the CPU's plain
``reduce_partials`` sums by. The emulation is held against two-pass
statistics in f64 and against the JAX package's ``_instance_norm``. The
kernels themselves run on a card (``test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livelyspeaker_tpu.models.audio_encoder import _instance_norm
from livelyspeaker_tpu_torch.ops import fused_wav as k3
from wav_stats_emulation import emulate_stats, offset_case, unshifted_stats

KERNEL_TOL = 1e-5  # chip_smoke.py's forward tolerance, relative
GRAD_TOL = 1e-4  # chip_smoke.py's gradient tolerance, which its reduce check uses


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def _errors(st, m):
    """(mean, 1/std) errors of st against two-pass f64 statistics of m,
    each relative to the largest of its kind."""
    ref = k3._norm_stats(m.double().transpose(1, 2))
    st = st.double()
    return _rel(st[:, 0], ref[:, 0]), _rel(st[:, 1], ref[:, 1])


# (B, T, C, offset): the TED shapes of m1 and m2 at small B, a short clip,
# a single row, and channel means 1e3 times their std
STATS_CASES = [(2, 1313, 64, 1.0), (3, 217, 128, 1.0), (2, 175, 64, 1.0), (1, 27, 128, 1.0),
               (1, 1, 64, 1.0), (4, 50, 32, 1.0), (2, 1313, 64, 1e3), (5, 217, 128, 1e3)]


@pytest.mark.parametrize("b,t,c,offset", STATS_CASES)
def test_stats_emulation_matches_f64(b, t, c, offset):
    """The kernel's statistics, emulated in f32, within KERNEL_TOL of the
    two-pass statistics in f64: the mean relative to the largest mean and
    1/std relative to the largest 1/std, also where the means are 1e3
    times the std."""
    m = offset_case(b, t, c, offset, seed=b * 1000 + t + c)
    st = emulate_stats(m)
    assert st.shape == (b, 2, c) and st.dtype == torch.float32
    mean_err, inv_err = _errors(st, m)
    assert mean_err <= KERNEL_TOL and inv_err <= KERNEL_TOL, (mean_err, inv_err)


@pytest.mark.parametrize("b,t,c", [(2, 1313, 64), (5, 217, 128)])
def test_unshifted_sums_miss_the_offset_case(b, t, c):
    """Why the kernel shifts its sums: f32 sums of x and x^2 without a shift
    lose 1/std where the means are 1e3 times the std."""
    m = offset_case(b, t, c, 1e3, seed=7)
    assert _errors(unshifted_stats(m), m)[1] > 100 * KERNEL_TOL
    assert _errors(emulate_stats(m), m)[1] <= KERNEL_TOL


@pytest.mark.parametrize("b,t,c", [(2, 217, 128), (3, 1313, 64), (2, 40, 32)])
def test_stats_emulation_matches_jax_instance_norm(b, t, c):
    """(m - mean) * inv from the emulated statistics against the JAX
    package's ``_instance_norm`` on the same time-major m [B, T, C] from a
    numpy seed, within KERNEL_TOL of its largest value."""
    rng = np.random.default_rng(b + t + c)
    m = (0.5 + rng.normal(size=(b, t, c))).astype(np.float32)
    want = np.array(jax.jit(_instance_norm)(jnp.asarray(m)))
    x = torch.from_numpy(m)
    st = emulate_stats(x)
    got = (x - st[:, :1]) * st[:, 1:]
    assert _rel(got, torch.from_numpy(want)) <= KERNEL_TOL


@pytest.mark.parametrize("b,t,c", [(1, 1313, 64), (8, 1313, 64), (8, 217, 128), (16, 217, 128),
                                   (512, 1313, 64), (512, 217, 128), (3, 1, 64), (1, 20, 32),
                                   (33, 175, 64), (2, 7891, 32)])
def test_stats_geometry_covers_every_time_once(b, t, c):
    """Each time of a sequence is read by exactly one thread of one CTA;
    the cluster is as large as b of them need to fill 132 SMs (at most 8,
    at most one a CTA step of rows), less at most half by whole steps a
    CTA, and no CTA is empty."""
    geo = k3.stats_geometry(b, t, c)
    step = 1024 // c
    want = min(8, -(-132 // b), -(-t // step))
    assert geo.rows_per_cta % step == 0
    assert -(-want // 2) <= geo.cluster <= want
    seen = np.zeros(t, dtype=int)
    for rank in range(geo.cluster):
        end = min(t, (rank + 1) * geo.rows_per_cta)
        assert rank * geo.rows_per_cta < end  # every CTA has rows
        for slot in range(step):
            rows = np.arange(rank * geo.rows_per_cta + slot, end, step)
            seen[rows] += 1
    assert (seen == 1).all()


def test_stats_geometry_fills_the_card_at_b8():
    """At TED's m1 and B = 8, 64 CTAs (clusters of 8), not 8."""
    assert k3.stats_geometry(8, 1313, 64).cluster == 8
    assert k3.stats_geometry(512, 1313, 64).cluster == 1


@pytest.mark.parametrize("b,t,c", [(0, 10, 64), (2, 0, 64), (2, 10, 96), (2, 10, 256),
                                   (2, 2 ** 24, 64)])
def test_stats_geometry_refuses_what_the_kernel_refuses(b, t, c):
    with pytest.raises(ValueError, match="stats_geometry"):
        k3.stats_geometry(b, t, c)


# (n, width): the four TED partials at B = 8 and 512 (conv3, conv2, conv1,
# conv0), one row, widths that are not multiples of 4
REDUCE_CASES = [(3, 491_776), (14, 123_008), (66, 30_784), (8, 512),
                (4, 491_776), (16, 123_008), (512, 512), (1, 1000), (7, 1001), (200, 3),
                (33, 30_785), (1, 1)]


def _kernel_groups(n, width):
    """{column vector: [rows of group 0, rows of group 1, ...]} as the
    reduce launch maps them: CTA, thread (vector tid % q, group tid // q),
    the groups in the order the kernel adds them."""
    geo = k3.reduce_geometry(n, width)
    cols = width // geo.vec
    out = {}
    for cta in range(geo.ctas):
        for tid in range(256):
            col, grp = tid % geo.vectors, tid // geo.vectors
            c = cta * geo.vectors + col
            j0 = min(n, grp * geo.rows)
            if c < cols and j0 < n:
                out.setdefault(c, []).append((grp, list(range(j0, min(n, j0 + geo.rows)))))
    return geo, {c: [rows for _, rows in sorted(v)] for c, v in out.items()}


@pytest.mark.parametrize("n,width", REDUCE_CASES)
def test_reduce_grouping_covers_every_cell_once(n, width):
    """Each (row, column vector) is read once, and every column's groups
    are the CPU's: group k the rows [k rows, (k + 1) rows) in order, added
    in group order; the grouping depends on (n, width) only."""
    geo, groups = _kernel_groups(n, width)
    assert geo == k3.reduce_geometry(n, width)
    assert geo.vec == (4 if width % 4 == 0 else 1)
    assert geo.ctas * geo.vectors >= width // geo.vec > (geo.ctas - 1) * geo.vectors
    cpu = [list(range(j0, min(n, j0 + geo.rows))) for j0 in range(0, n, geo.rows)]
    assert sorted(groups) == list(range(width // geo.vec))
    assert all(g == cpu for g in groups.values())


@pytest.mark.parametrize("b", [8, 512])
@pytest.mark.parametrize("i", [3, 2, 1, 0])
def test_reduce_partials_cpu_matches_f64(b, i):
    """The CPU ``reduce_partials`` on the TED partials of conv i (in
    ``wgrad_geometry``'s chunks; conv0's one row a sequence) within
    GRAD_TOL of the f64 sum, with the kernel's grouping."""
    d = k3.WavDims(36_267)
    t, ch = (d.T1, d.T2, d.T3, d.T4), k3.CHANNELS
    n = b if i == 0 else k3.wgrad_geometry(b, t[i], ch[i], ch[i + 1]).nsplit
    part = torch.randn(n, ch[i + 1] * ch[i] * 15 + ch[i + 1],
                       generator=torch.Generator().manual_seed(b + i))
    dw, db = k3.reduce_partials(part, i)
    flat = torch.cat([dw.reshape(-1), db])
    assert _rel(flat.double(), part.double().sum(0)) <= GRAD_TOL
    assert torch.equal(flat, k3._plain_reduce(part))


def test_reduce_geometry_refuses_what_the_kernel_refuses():
    for n, width in ((0, 512), (4, 0)):
        with pytest.raises(ValueError, match="reduce_geometry"):
            k3.reduce_geometry(n, width)


def test_cpu_tensors_run_the_plain_versions():
    """On CPU tensors ``norm_stats`` is the two-pass plain version and
    ``reduce_partials`` the plain grouped sum; no kernel is launched."""
    launches = dict(k3.LAUNCHES)
    m = offset_case(3, 217, 128, 1.0, seed=3)
    assert torch.equal(k3.norm_stats(m), k3._norm_stats(m.transpose(1, 2)))
    part = torch.randn(16, 123_008, generator=torch.Generator().manual_seed(4))
    dw, db = k3.reduce_partials(part, 2)
    assert torch.equal(torch.cat([dw.reshape(-1), db]), k3._plain_reduce(part))
    assert k3.LAUNCHES == launches
