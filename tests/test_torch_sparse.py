"""The sparse Hessian paths of tinyopt_tpu_torch — ``ops/block.BlockDiag``,
``ops/sparse_sym.SparseSym``, JAX-cg semantics (``ops.linalg.cg_to_tol``)
and ``sparse.block_optimize`` / ``sparse_optimize`` /
``matfree_optimize`` — against the JAX package on the same inputs made
with numpy, in float64: tests/test_sparse.py (without its compile-cache
tests, which have no counterpart), tests/test_fuzz_sparse.py:48-85 and
tests/test_dogleg.py:143-200.  Solves are held to rtol 1e-5 on x and cost,
iterations within 1 and the same success and convergence class
(tests/test_fused.py:51); assembled Hessians and covariances to 1e-9."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

import tinyopt_tpu as jto
from tinyopt_tpu import manifold as jmf
from tinyopt_tpu.manifolds import SE3 as JSE3
from tinyopt_tpu.manifolds import SO3 as JSO3
from tinyopt_tpu.models import problems as jp
from tinyopt_tpu.ops.block import BlockDiag as JBlockDiag
from tinyopt_tpu.ops.coloring import probe_structure as j_probe_structure
from tinyopt_tpu.ops.sparse_sym import SparseSym as JSparseSym
from tinyopt_tpu.optimizers.loop import optimize_from_acc as j_from_acc
from tinyopt_tpu.solvers.step import propose_step as j_propose_step
from tinyopt_tpu.sparse import block_nlls_system as j_block_system
from tinyopt_tpu.sparse import sparse_system as j_sparse_system

import tinyopt_tpu_torch as to
from tinyopt_tpu_torch import manifold as mf
from tinyopt_tpu_torch.interop import (options_from_reference,
                                       se3_from_numpy, so3_from_numpy)
from tinyopt_tpu_torch.manifolds import SE3, SO3
from tinyopt_tpu_torch.models import problems as tp
from tinyopt_tpu_torch.ops.block import BlockDiag
from tinyopt_tpu_torch.ops.coloring import probe_structure
from tinyopt_tpu_torch.ops.linalg import cg_to_tol
from tinyopt_tpu_torch.ops.sparse_sym import SegmentSum, SparseSym
from tinyopt_tpu_torch.optimizers.loop import optimize_from_acc
from tinyopt_tpu_torch.solvers.step import propose_step
from tinyopt_tpu_torch.sparse import (block_nlls_system, hutchinson_probes,
                                      sparse_system)
from tinyopt_tpu_torch.utils import where_tree

torch.set_num_threads(1)

F64 = torch.float64
HARD = jto.Options(max_iters=100, max_consec_failures=0)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def assert_parity(ref, got, rtol=1e-5, atol=1e-9, iter_slack=1):
    """tests/test_fused.py:51's parity: x and cost to rtol, iterations
    within ``iter_slack``, the same success and convergence class."""
    (xr, outr), (xg, outg) = ref, got
    for a, b in zip(jax.tree_util.tree_leaves(xr), pytree.tree_leaves(xg)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=rtol,
                                   atol=atol)
    np.testing.assert_array_equal(outg.succeeded().numpy(),
                                  np.asarray(outr.succeeded()))
    np.testing.assert_array_equal(outg.converged().numpy(),
                                  np.asarray(outr.converged()))
    assert np.max(np.abs(outg.num_iters.numpy()
                         - np.asarray(outr.num_iters))) <= iter_slack
    np.testing.assert_allclose(outg.final_cost.cost.numpy(),
                               np.asarray(outr.final_cost.cost), rtol=rtol,
                               atol=atol)


def _chain_j(x):
    return jnp.concatenate([3.0 * (x[1:] - x[:-1] * x[:-1]),
                            jnp.atleast_1d(x[0] - 0.7)])


def _chain_t(x):
    return torch.cat([3.0 * (x[1:] - x[:-1] * x[:-1]),
                      (x[0] - 0.7).reshape(1)])


def _spd_blocks(rng, B, nb, bs, shift=2.0):
    A = rng.normal(size=(B, nb, bs, bs))
    return A @ np.swapaxes(A, -1, -2) + shift * np.eye(bs)


# ---------------------------------------------------------------- BlockDiag

class TestBlockDiag:
    def test_dense_diag_matvec_match_reference(self):
        rng = np.random.default_rng(0)
        blocks = rng.uniform(-1, 1, (2, 3, 2, 2))
        v = rng.uniform(-1, 1, (2, 6))
        H = BlockDiag(_t(blocks))
        assert H.shape == (6, 6) and H.nb == 3 and H.bs == 2
        dense = H.to_dense()
        assert dense.shape == (2, 6, 6)
        for b in range(2):
            J = JBlockDiag(jnp.asarray(blocks[b]))
            np.testing.assert_array_equal(dense[b].numpy(),
                                          np.asarray(J.to_dense()))
            np.testing.assert_array_equal(H.diagonal()[b].numpy(),
                                          np.asarray(J.diagonal()))
            np.testing.assert_allclose(H.matvec(_t(v))[b].numpy(),
                                       np.asarray(J.matvec(jnp.asarray(v[b]))),
                                       rtol=1e-14, atol=1e-15)

    def test_solve_ands_blocks_per_instance_only(self):
        """``ok`` is the AND over one instance's blocks, never over the
        batch: a non-PD block fails its own instance only."""
        rng = np.random.default_rng(1)
        blocks = _spd_blocks(rng, 3, 4, 3, shift=3.0)
        blocks[1, 2] = -np.eye(3)
        b = rng.uniform(-1, 1, (3, 12))
        dx, ok = BlockDiag(_t(blocks)).solve(_t(b))
        assert ok.tolist() == [True, False, True]
        for i in (0, 2):
            dxr, okr = JBlockDiag(jnp.asarray(blocks[i])).solve(
                jnp.asarray(b[i]))
            assert bool(okr)
            np.testing.assert_allclose(dx[i].numpy(), np.asarray(dxr),
                                       rtol=1e-12, atol=1e-14)
        _, okr = JBlockDiag(jnp.asarray(blocks[1])).solve(jnp.asarray(b[1]))
        assert not bool(okr)

    def test_damp_and_inv_match_reference(self):
        rng = np.random.default_rng(2)
        blocks = _spd_blocks(rng, 2, 3, 2)
        blocks[0, 1, 0, 0] = 0.0           # absolute-λ fallback entry
        lam = np.array([0.5, 3.0])
        H = BlockDiag(_t(blocks))
        damped = H.damp(_t(lam)).blocks
        inv = H.inv().blocks
        for b in range(2):
            J = JBlockDiag(jnp.asarray(blocks[b]))
            np.testing.assert_array_equal(
                damped[b].numpy(), np.asarray(J.damp(lam[b]).blocks))
            np.testing.assert_allclose(inv[b].numpy(),
                                       np.asarray(J.inv().blocks),
                                       rtol=1e-12, atol=1e-14)

    def test_where_tree_selects_per_instance(self):
        a = BlockDiag(torch.zeros(3, 2, 1, 1, dtype=F64))
        b = BlockDiag(torch.ones(3, 2, 1, 1, dtype=F64))
        c = where_tree(torch.tensor([True, False, True]), a, b)
        assert isinstance(c, BlockDiag)
        assert c.blocks[:, 0, 0, 0].tolist() == [0.0, 1.0, 0.0]


# ---------------------------------------------------------- block_optimize

class TestBlockOptimize:
    @pytest.mark.parametrize("dims", [10, 100])
    def test_diag_problem(self, dims):
        """r_i = x_i² − i, block size 1, far start (tests/sparse.cpp:19-61,
        benchmarks/sparse.cpp:52-61)."""
        targets = np.arange(1.0, dims + 1.0).reshape(dims, 1)
        ref = jto.block_optimize(jnp.ones((dims, 1)),
                                 lambda xb, t: xb * xb - t,
                                 data=jnp.asarray(targets), options=HARD)
        got = to.block_optimize(torch.ones((dims, 1), dtype=F64),
                                lambda xb, t: xb * xb - t, data=_t(targets),
                                options=options_from_reference(HARD))
        assert_parity(ref, got)
        np.testing.assert_allclose(got[0].numpy().ravel(),
                                   np.sqrt(targets.ravel()), atol=1e-6)

    def test_matches_dense_path(self):
        targets = np.arange(1.0, 9.0).reshape(8, 1)
        x_blk, out_blk = to.block_optimize(
            torch.ones((8, 1), dtype=F64), lambda xb, t: xb * xb - t,
            data=_t(targets))
        x_d, out_d = to.optimize(torch.ones(8, dtype=F64),
                                 tp.sparse_diag_residual)
        np.testing.assert_allclose(x_blk.numpy().ravel(), x_d.numpy(),
                                   atol=1e-8)
        assert float(out_blk.final_cost.cost) == pytest.approx(
            float(out_d.final_cost.cost), abs=1e-10)
        np.testing.assert_allclose(out_blk.final_hessian.to_dense().numpy(),
                                   out_d.final_hessian.numpy(), atol=1e-9)

    @pytest.mark.parametrize("rescaled", [False, True])
    def test_covariance_matches_reference(self, rescaled):
        targets = np.arange(1.0, 5.0).reshape(4, 1)
        _, outr = jto.block_optimize(jnp.ones((4, 1)),
                                     lambda xb, t: xb * xb - t,
                                     data=jnp.asarray(targets))
        _, out = to.block_optimize(torch.ones((4, 1), dtype=F64),
                                   lambda xb, t: xb * xb - t,
                                   data=_t(targets))
        assert isinstance(out.final_hessian, BlockDiag)
        C = out.covariance(rescaled=rescaled)
        assert C.shape == (4, 4)
        np.testing.assert_allclose(C.numpy(), np.asarray(
            outr.covariance(rescaled=rescaled)), rtol=1e-9, atol=1e-12)
        if not rescaled:
            # J = diag(2x) → cov = diag(1/(4i))
            np.testing.assert_allclose(np.diag(C.numpy()),
                                       1.0 / (4.0 * np.arange(1.0, 5.0)),
                                       rtol=1e-5)

    def test_multidim_blocks(self):
        nb, bs = 6, 3
        targets = np.random.default_rng(2).uniform(-1, 1, (nb, bs))
        ref = jto.block_optimize(jnp.zeros((nb, bs)), lambda xb, t: xb - t,
                                 data=jnp.asarray(targets))
        got = to.block_optimize(torch.zeros((nb, bs), dtype=F64),
                                lambda xb, t: xb - t, data=_t(targets))
        assert_parity(ref, got)
        assert bool(got[1].converged())

    @pytest.mark.parametrize("entry", ["matfree", "sparse"])
    def test_rejects_gradient_descent(self, entry):
        fn = getattr(to, entry + "_optimize")
        with pytest.raises(ValueError, match="Gauss-Newton"):
            fn(torch.ones(3, dtype=F64), tp.sparse_diag_residual,
               to.Options(solver_type=to.GradientDescent))

    def test_batch_matches_vmap_of_reference(self):
        """``optimize_from_acc`` on a batch of block systems with data
        (the port's counterpart of the JAX bench's
        ``jax.vmap(optimize_from_acc(...))``), per instance, with the final
        BlockDiag of each instance its own."""
        rng = np.random.default_rng(3)
        B, nb, bs = 5, 4, 2
        tgt = rng.uniform(0.5, 2.0, (B, nb, bs))
        x0 = rng.uniform(0.5, 3.0, (B, nb, bs))

        def fn(xb, t):
            return xb * xb * xb - t

        opts = jto.Options(max_iters=40, max_consec_failures=0)
        spec_j = jmf.tangent_spec(jnp.asarray(x0[0]))

        def one(x, t):
            acc, ev, _ = j_block_system(fn, x, t)
            return j_from_acc(x, acc, ev, opts, spec_j)

        ref = jax.jit(jax.vmap(one))(jnp.asarray(x0), jnp.asarray(tgt))
        spec = mf.tangent_spec(_t(x0[0]))
        acc, ev, n_res = block_nlls_system(fn, _t(x0[0]), _t(tgt))
        assert n_res == nb * bs
        x, out = optimize_from_acc(_t(x0).reshape(B, -1), acc, ev,
                                   options_from_reference(opts), spec)
        assert_parity(ref, (x.reshape(B, nb, bs), out))
        np.testing.assert_allclose(out.final_hessian.blocks.numpy(),
                                   np.asarray(ref[1].final_hessian.blocks),
                                   rtol=1e-9, atol=1e-12)


# ------------------------------------------------ SparseSym and JAX-cg rule

def _jax_cg(A, b, M, maxiter, tol):
    return jax.scipy.sparse.linalg.cg(lambda v: A @ v, b, maxiter=maxiter,
                                      tol=tol, M=M)[0]


class TestCG:
    @pytest.mark.parametrize("precond", [False, True])
    def test_matches_jax_scipy_cg(self, precond):
        """One batch: a diagonal system with powers of two that converges
        EXACTLY in one iteration (r = 0, then stops instead of 0/0), SPD
        systems that stop at different iterations at tol 1e-6, one that
        runs out of iterations, and a NaN instance beside them."""
        rng = np.random.default_rng(4)
        d, maxiter, tol = 6, 5, 1e-6
        As = []
        As.append(np.diag(2.0 ** np.arange(1, d + 1)))
        for scale in (1e-3, 0.3, 3.0):
            Q = rng.normal(size=(d, d))
            As.append(np.eye(d) + scale * (Q @ Q.T))
        As.append(np.eye(d) + np.diag(np.arange(d)))
        bs = [np.arange(1.0, d + 1)] + [rng.normal(size=d) for _ in range(4)]
        As.append(As[1])
        bs.append(np.full(d, np.nan))
        A, b = np.stack(As), np.stack(bs)
        At, bt = _t(A), _t(b)
        dinv = 1.0 / torch.diagonal(At, dim1=-2, dim2=-1)
        calls = []

        def mv(v):
            calls.append(1)
            return torch.matmul(At, v[..., None])[..., 0]

        x = cg_to_tol(mv, bt, maxiter=maxiter, tol=tol,
                      precond=(lambda v: v * dinv) if precond else None)
        assert torch.all(torch.isfinite(x[:-1]))
        assert torch.all(x[-1] == 0)                # NaN b: no iteration
        for i in range(len(A) - 1):
            M = ((lambda v, i=i: v / jnp.diagonal(jnp.asarray(A[i])))
                 if precond else None)
            xr = _jax_cg(jnp.asarray(A[i]), jnp.asarray(b[i]), M, maxiter,
                         tol)
            np.testing.assert_allclose(x[i].numpy(), np.asarray(xr),
                                       rtol=1e-10, atol=1e-14,
                                       err_msg=f"instance {i}")
        xr = _jax_cg(jnp.asarray(A[-1]), jnp.asarray(b[-1]), None, maxiter,
                     tol)
        np.testing.assert_array_equal(np.asarray(xr), 0.0)
        # the exactly converging instance stopped after one iteration
        if precond:
            np.testing.assert_array_equal(x[0].numpy(),
                                          b[0] / np.diag(A[0]))
        assert len(calls) == maxiter + 1

    def test_float32_subnormal_residual_stops(self):
        """A float32 residual that shrinks into the subnormal range stops
        its instance (the one departure from JAX's rule, ops/linalg.py):
        every iterate stays finite where JAX's cg divides 0 by 0 on some,
        and equals JAX's wherever JAX's is finite."""
        rng = np.random.default_rng(21)
        b = (10 * (10 * rng.uniform(-1, 1, (256, 10)) - 2)).astype(
            np.float32)
        d = np.float32(100.0) * np.float32(1.0001)
        x = cg_to_tol(lambda v: d * v, torch.from_numpy(b), maxiter=8,
                      precond=lambda v: v / d)
        xr = np.asarray(jax.vmap(lambda bb: jax.scipy.sparse.linalg.cg(
            lambda v: d * v, bb, maxiter=8, tol=0.0,
            M=lambda v: v / d)[0])(jnp.asarray(b)))
        assert bool(torch.all(torch.isfinite(x)))
        fin = np.all(np.isfinite(xr), axis=-1)
        assert fin.sum() > 128
        np.testing.assert_allclose(x.numpy()[fin], xr[fin], rtol=1e-6)

    def test_float32_sparse_bench_ends_no_instance_failed(self):
        """The reference's sparse benchmark problem (r = 10x − 2, d = 10,
        10,000 float32 instances, ``bench_sparse``'s options with
        ``cg_iters=8``) through the COO path of both packages from the
        same numpy-seeded starts: JAX's cg runs on while a residual is
        subnormal and ends some instances SOLVER_FAILED (13 of these
        10,000); the port stops them and ends none, every x at 0.2."""
        d, n = 10, 10_000
        jo = jto.Options(
            max_iters=10, min_error=0.0, min_rerr_dec=1e-12,
            min_step_norm2=1e-16, max_consec_failures=3, save_history=False,
            hessian=jto.HessianOptions(save_last=False, carry_system=False,
                                       cg_iters=8))
        x0 = np.random.default_rng(5).uniform(-1, 1, (n, d)).astype(
            np.float32)

        def res(x):
            return 10.0 * x - 2.0

        x_ex = jnp.asarray(x0[0])
        spec = jmf.tangent_spec(x_ex)
        acc, ev, _ = j_sparse_system(
            res, x_ex, spec, j_probe_structure(res, x_ex, None, spec, d, d))
        _, oj = jax.jit(jax.vmap(
            lambda x: j_from_acc(x, acc, ev, jo, spec)))(jnp.asarray(x0))
        t_ex = torch.from_numpy(x0[0])
        tspec = mf.tangent_spec(t_ex)
        tacc, tev, _ = sparse_system(
            res, t_ex, tspec, probe_structure(res, t_ex, None, tspec, d, d))
        xt, ot = optimize_from_acc(torch.from_numpy(x0), tacc, tev,
                                   options_from_reference(jo), tspec)
        failed = int(jto.StopReason.SOLVER_FAILED)
        assert int(np.sum(np.asarray(oj.stop_reason) == failed)) == 13
        assert int((ot.stop_reason == failed).sum()) == 0
        assert float((xt - 0.2).abs().max()) == 0.0

    def test_sparsesym_solve_matches_reference(self):
        rng = np.random.default_rng(7)
        A = rng.uniform(-1, 1, (6, 6))
        dense = A @ A.T + 6 * np.eye(6)
        rows, cols = np.nonzero(np.ones((6, 6), bool))
        vals = np.stack([dense[rows, cols], 2.0 * dense[rows, cols]])
        H = SparseSym.from_pattern(rows, cols, _t(vals), 6)
        b = rng.uniform(-1, 1, (2, 6))
        for iters in (0, 3):
            dx, ok = H.solve(_t(b), cg_iters=iters)
            assert ok.tolist() == [True, True]
            for i in range(2):
                J = JSparseSym.from_pattern(rows, cols, jnp.asarray(vals[i]),
                                            6)
                dxr, _ = J.solve(jnp.asarray(b[i]), cg_iters=iters)
                np.testing.assert_allclose(dx[i].numpy(), np.asarray(dxr),
                                           rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(H.solve(_t(b))[0][0].numpy(),
                                   np.linalg.solve(dense, b[0]), atol=1e-8)

    def test_damping_is_multiplicative(self):
        rows, cols = np.array([0, 0, 1, 1, 2]), np.array([0, 1, 0, 1, 2])
        vals = np.array([[2.0, 0.5, 0.5, 3.0, 0.0],
                         [1.0, 0.5, 0.5, 4.0, 1.0]])
        H = SparseSym.from_pattern(rows, cols, _t(vals), 3)
        lam = np.array([0.1, 2.0])
        Hd = H.damp(_t(lam))
        np.testing.assert_allclose(Hd.to_dense()[0].numpy(),
                                   [[2.2, 0.5, 0], [0.5, 3.3, 0],
                                    [0, 0, 0.1]], atol=1e-12)
        for i in range(2):
            J = JSparseSym.from_pattern(rows, cols, jnp.asarray(vals[i]), 3)
            np.testing.assert_array_equal(
                Hd.vals[i].numpy(), np.asarray(J.damp(lam[i]).vals))
            np.testing.assert_array_equal(H.diagonal()[i].numpy(),
                                          np.asarray(J.diagonal()))
            np.testing.assert_array_equal(H.to_dense()[i].numpy(),
                                          np.asarray(J.to_dense()))

    def test_inv_retries_singular_instance_only(self):
        """The diagonal-shift retry (math.h:115-137) runs for the
        instance whose first solve is non-finite; the other keeps its
        plain inverse."""
        rows, cols = np.array([0, 0, 1, 1]), np.array([0, 1, 0, 1])
        vals = np.array([[2.0, 0.5, 0.5, 3.0], [1.0, 1.0, 1.0, 1.0]])
        C = SparseSym.from_pattern(rows, cols, _t(vals), 2).inv().to_dense()
        for i in range(2):
            Cr = JSparseSym.from_pattern(rows, cols, jnp.asarray(vals[i]),
                                         2).inv().to_dense()
            np.testing.assert_allclose(C[i].numpy(), np.asarray(Cr),
                                       rtol=1e-9)
        assert torch.all(torch.isfinite(C))

    @pytest.mark.parametrize("m", [40, 10_000])
    def test_segment_sum_is_scatter_add(self, m):
        """Against ``np.add.at``; at m = 10,000 nine entries in ten fall in
        one segment, and the tables still hold O(m) entries (not
        n_out × the longest segment)."""
        rng = np.random.default_rng(8)
        n_out = 7 if m == 40 else 500
        seg = rng.integers(0, n_out, m)
        seg[seg == 3] = 4                          # an empty segment
        seg[rng.uniform(size=m) < (0.0 if m == 40 else 0.9)] = 1
        v = rng.normal(size=(3, m))
        want = np.zeros((3, n_out))
        for b in range(3):
            np.add.at(want[b], seg, v[b])
        ss = SegmentSum(seg, n_out)
        # the 9,000-entry segment sums in levels, np.add.at in sequence
        tol = 1e-15 if m == 40 else 1e-12
        np.testing.assert_allclose(ss(_t(v)).numpy(), want,
                                   rtol=10 * tol, atol=tol)
        assert sum(t.numel() for t in ss.tables) <= 2 * (m + 16 * n_out)

    def test_where_tree_selects_vals_only(self):
        rows, cols = np.array([0, 1]), np.array([0, 1])
        a = SparseSym.from_pattern(rows, cols, torch.zeros(2, 2), 2)
        b = SparseSym(torch.ones(2, 2), a.pattern)
        c = where_tree(torch.tensor([False, True]), a, b)
        assert c.pattern is a.pattern
        assert c.vals.tolist() == [[1.0, 1.0], [0.0, 0.0]]


# --------------------------------------------------------- sparse_optimize

class TestSparseOptimize:
    def test_diag_problem_detected_structure(self):
        dims = 20
        ref = jto.sparse_optimize(jnp.ones(dims), jp.sparse_diag_residual,
                                  HARD)
        got = to.sparse_optimize(torch.ones(dims, dtype=F64),
                                 tp.sparse_diag_residual,
                                 options_from_reference(HARD))
        assert_parity(ref, got)
        H = got[1].final_hessian
        assert isinstance(H, SparseSym)
        assert H.vals.shape == (dims,)
        np.testing.assert_allclose(H.to_dense().numpy(), np.asarray(
            ref[1].final_hessian.to_dense()), rtol=1e-9, atol=1e-9)

    @pytest.mark.parametrize("solver", ["lm", "gn", "dogleg"])
    def test_coupled_matches_reference_and_dense(self, solver):
        """The chain problem (tridiagonal H): the JAX sparse path's
        trajectory, and the port's dense H at the optimum to 1e-9."""
        st = {"lm": jto.LevenbergMarquardt, "gn": jto.GaussNewton,
              "dogleg": jto.DogLeg}[solver]
        o = jto.Options(solver_type=st, max_iters=60, max_consec_failures=0)
        ref = jto.sparse_optimize(jnp.full(6, 0.5), _chain_j, o)
        got = to.sparse_optimize(torch.full((6,), 0.5, dtype=F64), _chain_t,
                                 options_from_reference(o))
        assert_parity(ref, got)
        xd, outd = to.optimize(torch.full((6,), 0.5, dtype=F64), _chain_t,
                               options_from_reference(o))
        np.testing.assert_allclose(got[0].numpy(), xd.numpy(), atol=1e-8)
        np.testing.assert_allclose(got[1].final_hessian.to_dense().numpy(),
                                   outd.final_hessian.numpy(), rtol=1e-9,
                                   atol=1e-9)

    def test_explicit_structure(self):
        dims = 6
        ref = jto.sparse_optimize(jnp.ones(dims), jp.sparse_diag_residual,
                                  HARD, structure=np.eye(dims, dtype=bool))
        got = to.sparse_optimize(torch.ones(dims, dtype=F64),
                                 tp.sparse_diag_residual,
                                 options_from_reference(HARD),
                                 structure=np.eye(dims, dtype=bool))
        assert_parity(ref, got)

    def test_structure_errors(self):
        with pytest.raises(ValueError, match="structure shape"):
            to.sparse_optimize(torch.ones(4, dtype=F64),
                               tp.sparse_diag_residual,
                               structure=np.eye(3, dtype=bool))
        with pytest.raises(ValueError, match="sparsity structure"):
            to.sparse_optimize(torch.ones(3, dtype=F64),
                               lambda x: torch.sqrt(x - 5.0))

    @pytest.mark.parametrize("rescaled", [False, True])
    def test_covariance_matches_reference(self, rescaled):
        dims = 5
        _, outr = jto.sparse_optimize(jnp.ones(dims), jp.sparse_diag_residual,
                                      HARD)
        _, out = to.sparse_optimize(torch.ones(dims, dtype=F64),
                                    tp.sparse_diag_residual,
                                    options_from_reference(HARD))
        C = out.covariance(rescaled=rescaled)
        np.testing.assert_allclose(C.numpy(), np.asarray(
            outr.covariance(rescaled=rescaled)), rtol=1e-9, atol=1e-12)

    def test_manifold_params(self):
        w = np.array([0.3, -0.2, 0.1])
        jprior = JSO3.exp(jnp.asarray(w))
        ref = jto.sparse_optimize(JSO3.identity(jnp.float64),
                                  lambda R: (jprior @ R).log())
        prior = so3_from_numpy(np.asarray(jprior.wxyz), device="cpu",
                               dtype=F64)
        got = to.sparse_optimize(SO3.identity(F64),
                                 lambda R: (prior @ R).log())
        assert_parity(ref, got)
        assert float(torch.linalg.norm((got[0] @ prior).log())) < 1e-7

    def test_no_carry_no_save_config(self):
        o = jto.Options(max_iters=100, max_consec_failures=0,
                        hessian=jto.HessianOptions(carry_system=False,
                                                   save_last=False))
        ref = jto.sparse_optimize(jnp.ones(5), jp.sparse_diag_residual, o)
        got = to.sparse_optimize(torch.ones(5, dtype=F64),
                                 tp.sparse_diag_residual,
                                 options_from_reference(o))
        assert_parity(ref, got)
        assert got[1].final_hessian is None

    def test_batch_matches_vmap_of_reference(self):
        """``sparse_system`` on a batch of 8 through ``optimize_from_acc``
        against the JAX package's vmap (tests/test_sparse.py's
        test_vmap_batched_sparse), per instance, final SparseSym
        included."""
        d = 6
        x_ex = jnp.full(d, 0.5)
        spec_j = jmf.tangent_spec(x_ex)
        structure = j_probe_structure(_chain_j, x_ex, None, spec_j, d, d)
        acc_j, ev_j, _ = j_sparse_system(_chain_j, x_ex, spec_j, structure)
        o = jto.Options(max_consec_failures=0, max_iters=60)
        x0 = np.random.default_rng(0).uniform(0.3, 0.8, (8, d))
        ref = jax.jit(jax.vmap(
            lambda x: j_from_acc(x, acc_j, ev_j, o, spec_j)))(
                jnp.asarray(x0))
        spec = mf.tangent_spec(_t(x_ex))
        got_structure = probe_structure(_chain_t, _t(x_ex), None, spec, d, d)
        np.testing.assert_array_equal(got_structure, structure)
        acc, ev, _ = sparse_system(_chain_t, _t(x_ex), spec, got_structure)
        got = optimize_from_acc(_t(x0), acc, ev, options_from_reference(o),
                                spec)
        assert_parity(ref, got)
        assert bool(torch.all(got[1].converged()))
        np.testing.assert_allclose(got[1].final_hessian.vals.numpy(),
                                   np.asarray(ref[1].final_hessian.vals),
                                   rtol=1e-9, atol=1e-9)


# ------------------------------------------------------- matfree_optimize

class TestMatfreeOptimize:
    def test_matches_reference_lm(self):
        o = jto.Options(max_iters=150, max_consec_failures=0)
        ref = jto.matfree_optimize(jnp.array([-1.2, 1.0]),
                                   jp.rosenbrock_residuals, o)
        got = to.matfree_optimize(torch.tensor([-1.2, 1.0], dtype=F64),
                                  tp.rosenbrock_residuals,
                                  options_from_reference(o))
        assert_parity(ref, got)
        np.testing.assert_allclose(got[0].numpy(), [1.0, 1.0], atol=1e-4)
        assert got[1].final_hessian is None

    def test_large_dim_diag(self):
        dims = 1000
        o = jto.Options(max_iters=100, max_consec_failures=0)
        ref = jto.matfree_optimize(jnp.ones(dims), jp.sparse_diag_residual,
                                   o, cg_iters=50)
        got = to.matfree_optimize(torch.ones(dims, dtype=F64),
                                  tp.sparse_diag_residual,
                                  options_from_reference(o), cg_iters=50)
        assert_parity(ref, got)
        np.testing.assert_allclose(got[0].numpy(),
                                   np.sqrt(np.arange(1.0, dims + 1.0)),
                                   atol=1e-4)

    def test_manifold_params(self):
        jprior = JSE3.exp(jnp.asarray(np.linspace(-0.4, 0.4, 6)))
        ref = jto.matfree_optimize(JSE3.identity(jnp.float64),
                                   lambda x: (jprior @ x).log())
        prior = se3_from_numpy(np.asarray(jprior.rotation.wxyz),
                               np.asarray(jprior.translation), device="cpu",
                               dtype=F64)
        got = to.matfree_optimize(SE3.identity(F64),
                                  lambda x: (prior @ x).log())
        assert_parity(ref, got)
        assert float(torch.linalg.norm((got[0] @ prior).log())) < 1e-5


class TestMatfreePrecond:
    """The Hutchinson-Jacobi preconditioner.  Its ±1 probes are drawn
    from torch's generator, not jax.random, so they differ from the JAX
    package's by design; on a diagonal JᵀJ the estimate (JᵀJv) ⊙ v is the
    exact diagonal for ANY ±1 v, so there both packages solve the same
    systems."""

    def _ill_scaled(self):
        rng = np.random.default_rng(0)
        d = 200
        return (d, 10.0 ** rng.uniform(-3, 3, d), rng.normal(size=d))

    def test_ill_scaled_diagonal_matches_reference(self):
        d, scales, tgt = self._ill_scaled()
        o = jto.Options(max_iters=30, max_consec_failures=0)
        js, jt = jnp.asarray(scales), jnp.asarray(tgt)
        ts_, tt = _t(scales), _t(tgt)
        ref = jto.matfree_optimize(jnp.zeros(d), lambda x: js * (x - jt), o,
                                   cg_iters=30, precond_probes=8)
        got = to.matfree_optimize(torch.zeros(d, dtype=F64),
                                  lambda x: ts_ * (x - tt),
                                  options_from_reference(o), cg_iters=30,
                                  precond_probes=8)
        assert_parity(ref, got, atol=1e-12)
        plain = to.matfree_optimize(torch.zeros(d, dtype=F64),
                                    lambda x: ts_ * (x - tt),
                                    options_from_reference(o), cg_iters=30)
        assert float(got[1].final_cost.cost) < 1e-12
        assert int(got[1].num_iters) < 10
        assert float(got[1].final_cost.cost) < 1e-6 * float(
            plain[1].final_cost.cost)

    def test_coupled_probed_solve_converges_to_dense_optimum(self):
        """On a coupled problem the estimate is not exact: the probed
        solve is held to its own convergence and to the dense optimum."""
        o = to.Options(max_iters=100, max_consec_failures=0)
        x, out = to.matfree_optimize(torch.full((8,), 0.5, dtype=F64),
                                     _chain_t, o, precond_probes=4)
        xd, _ = to.optimize(torch.full((8,), 0.5, dtype=F64), _chain_t, o)
        assert bool(out.converged())
        np.testing.assert_allclose(x.numpy(), xd.numpy(), atol=1e-6)

    def test_probes_are_fixed_rademacher(self):
        v = hutchinson_probes(4, 9)
        assert v.shape == (4, 9) and set(v.unique().tolist()) <= {-1.0, 1.0}
        assert torch.equal(v, hutchinson_probes(4, 9))

    def test_off_path_unchanged(self):
        fn = lambda x: x - torch.arange(20.0, dtype=F64)     # noqa: E731
        o = to.Options(max_consec_failures=0)
        x1, o1 = to.matfree_optimize(torch.ones(20, dtype=F64), fn, o)
        x2, o2 = to.matfree_optimize(torch.ones(20, dtype=F64), fn, o,
                                     precond_probes=0)
        assert torch.equal(x1, x2)
        assert bool(o1.converged()) and bool(o2.converged())


# ----------------------------------------- tests/test_fuzz_sparse.py:48-85

def _random_sparse_program(rng, d, n_res):
    """tests/test_fuzz_sparse.py's random residual with a random static
    structure, for both packages."""
    structure = rng.uniform(size=(n_res, d)) < rng.uniform(0.15, 0.6)
    for i in range(n_res):
        if not structure[i].any():
            structure[i, rng.integers(0, d)] = True
    for j in range(d):
        if not structure[:, j].any():
            structure[rng.integers(0, n_res), j] = True
    A = structure * rng.normal(0, 1.0, (n_res, d))
    y = rng.uniform(-1, 1, (n_res,))
    kind = int(rng.integers(0, 3))

    def make(A, y, tanh):
        def residual(x):
            z = A @ x
            if kind == 0:
                return z - y
            if kind == 1:
                return tanh(z) - y
            return z + 0.1 * z * z - y
        return residual

    return (make(jnp.asarray(A), jnp.asarray(y), jnp.tanh),
            make(_t(A), _t(y), torch.tanh), structure)


@pytest.mark.parametrize("seed", range(8))
def test_sparse_matches_dense(seed):
    rng = np.random.default_rng(200 + seed)
    d = int(rng.integers(3, 14))
    n_res = int(rng.integers(d, 2 * d + 6))
    jres, tres, _ = _random_sparse_program(rng, d, n_res)
    x0 = rng.uniform(-0.5, 0.5, (d,))
    o = jto.Options(max_iters=30, max_consec_failures=0)
    ref = jto.sparse_optimize(jnp.asarray(x0), jres, o)
    got = to.sparse_optimize(_t(x0), tres, options_from_reference(o))
    assert_parity(ref, got)
    xd, outd = to.optimize(_t(x0), tres, options_from_reference(o))
    # the same assembled system at the optimum, and the same endpoint
    np.testing.assert_allclose(got[1].final_hessian.to_dense().numpy(),
                               outd.final_hessian.numpy(), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(got[0].numpy(), xd.numpy(), rtol=1e-6,
                               atol=1e-7)
    assert bool(got[1].succeeded()) == bool(outd.succeeded())


@pytest.mark.parametrize("seed", range(4))
def test_detected_structure_matches_reference(seed):
    """Probing finds every true nonzero, and the same structure as the JAX
    package (same numpy-seeded probe points)."""
    rng = np.random.default_rng(300 + seed)
    d = int(rng.integers(3, 12))
    n_res = int(rng.integers(d, 2 * d))
    jres, tres, structure = _random_sparse_program(rng, d, n_res)
    x0 = rng.uniform(-0.5, 0.5, (d,))
    detected = probe_structure(tres, _t(x0), None, mf.tangent_spec(_t(x0)),
                               n_res, d)
    assert detected is not None
    assert not (structure & ~detected).any()
    ref = j_probe_structure(jres, jnp.asarray(x0), None,
                            jmf.tangent_spec(jnp.asarray(x0)), n_res, d)
    np.testing.assert_array_equal(detected, ref)


def test_arrow_pattern_matches_dense():
    """One parameter shared by every residual (an arrow-shaped J): g's
    segment of that column holds n_res entries and H's row of it dims
    entries.  The assembled H and g equal the dense JᵀJ and Jᵀr and the
    JAX package's sparse assembly within 1e-9."""
    n = 300
    rng = np.random.default_rng(31)
    tgt = rng.uniform(-1, 1, n)

    def make(cat, t):
        def residual(x):
            return cat([x[:-1] * (1.0 + 0.5 * x[-1]) - t, x[-1:] - 0.3])
        return residual

    jres = make(jnp.concatenate, jnp.asarray(tgt))
    tres = make(torch.cat, _t(tgt))
    structure = np.zeros((n + 1, n + 1), bool)
    structure[np.arange(n), np.arange(n)] = True
    structure[:, n] = True
    x = rng.uniform(-0.5, 0.5, n + 1)
    spec = mf.tangent_spec(_t(x))
    acc, _, _ = sparse_system(tres, _t(x), spec, structure)
    H, g, _ = acc(_t(x)[None])
    J = torch.func.jacfwd(tres)(_t(x))
    np.testing.assert_allclose(H.to_dense()[0].numpy(), (J.T @ J).numpy(),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(g[0].numpy(), (J.T @ tres(_t(x))).numpy(),
                               rtol=1e-9, atol=1e-12)
    jacc, _, _ = j_sparse_system(jres, jnp.asarray(x),
                                 jmf.tangent_spec(jnp.asarray(x)), structure)
    Hr, gr, _ = jacc(jnp.asarray(x))
    np.testing.assert_allclose(H.to_dense()[0].numpy(),
                               np.asarray(Hr.to_dense()), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(g[0].numpy(), np.asarray(gr), rtol=1e-9,
                               atol=1e-12)
    for table in (H.pattern.by_row.tables[0],):
        assert table.numel() <= 2 * (H.vals.shape[-1] + 16 * (n + 1))


class _Largest(TorchDispatchMode):
    """The most entries of any tensor an operation makes while active."""

    def __init__(self):
        super().__init__()
        self.numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.numel = max(self.numel, t.numel())
        return out


@pytest.mark.parametrize("entry", ["block", "sparse", "matfree"])
def test_no_tensor_of_dims_squared(entry):
    """At d = 2,000 no tensor of the solve has d² entries (a dense
    Hessian): the loop's carried H is what the first build makes, as the
    JAX package takes its shape from ``eval_shape``.  Every tensor here
    holds O(d) entries."""
    d = 2000
    o = to.Options(max_iters=5, max_consec_failures=0)
    tgt = torch.arange(1.0, d + 1.0, dtype=F64)
    x0 = 1.1 * torch.sqrt(tgt)
    with _Largest() as m:
        if entry == "block":
            x, out = to.block_optimize(x0[:, None], lambda xb, t: xb * xb - t,
                                       o, data=tgt[:, None])
        elif entry == "sparse":
            x, out = to.sparse_optimize(x0, tp.sparse_diag_residual, o,
                                        structure=np.eye(d, dtype=bool))
        else:
            x, out = to.matfree_optimize(x0, tp.sparse_diag_residual, o,
                                         cg_iters=10)
    cost0 = float(torch.sum((x0 * x0 - tgt) ** 2))
    assert bool(out.succeeded())
    assert float(out.final_cost.cost) < 1e-3 * cost0
    assert m.numel <= 16 * d, m.numel


# ------------------------------------------ tests/test_dogleg.py:143-200

class TestDogLegAllRepresentations:
    LAMS = (1e-6, 1.0, 50.0)

    def test_blockdiag_propose_matches_dense_and_reference(self):
        rng = np.random.default_rng(0)
        blocks = _spd_blocks(rng, 1, 3, 2)[0]
        g = rng.normal(size=(6,))
        jo = jto.Options(solver_type=jto.DogLeg)
        o = options_from_reference(jo)
        n = len(self.LAMS)
        H = BlockDiag(_t(np.broadcast_to(blocks, (n,) + blocks.shape)))
        gb, lams = _t(np.broadcast_to(g, (n, 6))), _t(self.LAMS)
        dx_b, ok_b = propose_step(H, gb, lams, o)
        dx_d, ok_d = propose_step(H.to_dense(), gb, lams, o)
        assert bool(ok_b.all()) and bool(ok_d.all())
        np.testing.assert_allclose(dx_b.numpy(), dx_d.numpy(), rtol=1e-8,
                                   atol=1e-12)
        for i, lam in enumerate(self.LAMS):
            dxr, okr = j_propose_step(JBlockDiag(jnp.asarray(blocks)),
                                      jnp.asarray(g), jnp.asarray(lam), jo)
            assert bool(okr)
            np.testing.assert_allclose(dx_b[i].numpy(), np.asarray(dxr),
                                       rtol=1e-9, atol=1e-14)

    @pytest.mark.parametrize("solver", ["lm", "dogleg"])
    def test_sparsesym_propose_matches_reference(self, solver):
        st = {"lm": jto.LevenbergMarquardt, "dogleg": jto.DogLeg}[solver]
        rng = np.random.default_rng(1)
        A = rng.normal(size=(5, 5)) * (rng.uniform(size=(5, 5)) < 0.5)
        dense = A @ A.T + np.diag(rng.uniform(0.1, 1.0, 5))
        rows, cols = np.nonzero(dense)
        g = rng.normal(size=5)
        jo = jto.Options(solver_type=st,
                         hessian=jto.HessianOptions(cg_iters=3))
        n = len(self.LAMS)
        H = SparseSym.from_pattern(
            rows, cols, _t(np.broadcast_to(dense[rows, cols],
                                           (n, rows.size))), 5)
        dx, ok = propose_step(H, _t(np.broadcast_to(g, (n, 5))),
                              _t(self.LAMS), options_from_reference(jo))
        J = JSparseSym.from_pattern(rows, cols, jnp.asarray(
            dense[rows, cols]), 5)
        for i, lam in enumerate(self.LAMS):
            dxr, okr = j_propose_step(J, jnp.asarray(g), jnp.asarray(lam), jo)
            assert bool(ok[i]) == bool(okr)
            np.testing.assert_allclose(dx[i].numpy(), np.asarray(dxr),
                                       rtol=1e-9, atol=1e-14)

    def test_block_optimize_dogleg(self):
        o = jto.Options(solver_type=jto.DogLeg, max_iters=100,
                        max_consec_failures=0)
        ref = jto.block_optimize(jnp.full((4, 2), 3.0),
                                 lambda xb: xb ** 2 - jnp.arange(1.0, 3.0), o)
        tgt = torch.arange(1.0, 3.0, dtype=F64)
        got = to.block_optimize(torch.full((4, 2), 3.0, dtype=F64),
                                lambda xb: xb ** 2 - tgt,
                                options_from_reference(o))
        assert_parity(ref, got)
        assert bool(got[1].converged())

    def test_sparse_optimize_dogleg_matches_reference(self):
        def banded_j(x):
            return jnp.concatenate([x[:-1] + 0.5 * x[1:]
                                    - jnp.arange(1.0, 8.0), x[-1:] - 2.0])

        def banded_t(x):
            return torch.cat([x[:-1] + 0.5 * x[1:]
                              - torch.arange(1.0, 8.0, dtype=F64),
                              x[-1:] - 2.0])

        o = jto.Options(solver_type=jto.DogLeg, max_iters=200,
                        max_consec_failures=0)
        ref = jto.sparse_optimize(jnp.full((8,), 4.0), banded_j, o)
        got = to.sparse_optimize(torch.full((8,), 4.0, dtype=F64), banded_t,
                                 options_from_reference(o))
        assert_parity(ref, got)
        xd, _ = to.optimize(torch.full((8,), 4.0, dtype=F64), banded_t,
                            options_from_reference(o))
        np.testing.assert_allclose(got[0].numpy(), xd.numpy(), rtol=1e-6,
                                   atol=1e-8)

    def test_matfree_dogleg_wood(self):
        """The reference's disabled hard problem through the matrix-free
        trust region (dogleg over CG)."""
        o = jto.Options(solver_type=jto.DogLeg, max_iters=500,
                        max_consec_failures=0)
        ref = jto.matfree_optimize(jnp.array([-3.0, -1.0, -3.0, -1.0]),
                                   jp.wood_residuals, o)
        got = to.matfree_optimize(
            torch.tensor([-3.0, -1.0, -3.0, -1.0], dtype=F64),
            tp.wood_residuals, options_from_reference(o))
        assert_parity(ref, got)
        assert bool(got[1].converged())
        np.testing.assert_allclose(got[0].numpy(), 1.0, atol=1e-5)


# ------------------------------------------------------- on the card only

@pytest.mark.cuda
def test_sparse_paths_on_gpu():
    """chip_smoke.py phase 13 in small: the block, COO and matrix-free
    paths on the card against the same solves on the CPU (float64)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    o = to.Options(max_iters=30, max_consec_failures=0)
    for fn in (to.sparse_optimize, to.matfree_optimize):
        x, out = fn(torch.full((16,), 0.5, dtype=F64, device=dev), _chain_t,
                    o)
        xc, outc = fn(torch.full((16,), 0.5, dtype=F64), _chain_t, o)
        torch.testing.assert_close(x.cpu(), xc, rtol=1e-9, atol=1e-12)
        assert int(out.num_iters) == int(outc.num_iters)
    tgt = torch.arange(1.0, 9.0, dtype=F64).reshape(8, 1)
    x, out = to.block_optimize(torch.ones((8, 1), dtype=F64, device=dev),
                               lambda xb, t: xb * xb - t, o,
                               data=tgt.to(dev))
    xc, _ = to.block_optimize(torch.ones((8, 1), dtype=F64),
                              lambda xb, t: xb * xb - t, o, data=tgt)
    torch.testing.assert_close(x.cpu(), xc, rtol=1e-12, atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["block", "matfree"])
def test_large_dims_fit_on_gpu(entry):
    """At d = 100,000 (a dense Hessian would take 80 GB in float64) the
    block and matrix-free paths, default carry, solve on the card in less
    than 1 GB."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d = 100_000
    x0 = torch.linspace(-1.0, 1.0, d, dtype=F64, device="cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    o = to.Options(max_iters=10)
    if entry == "block":
        x, out = to.block_optimize(x0[:, None], lambda xb: 10.0 * xb - 2.0,
                                   o)
    else:
        x, out = to.matfree_optimize(x0, lambda x: 10.0 * x - 2.0, o,
                                     cg_iters=8)
    assert (torch.cuda.max_memory_allocated() - base) < 1e9
    assert bool(out.succeeded())
    torch.testing.assert_close(x.reshape(-1), torch.full_like(x0, 0.2),
                               rtol=0, atol=1e-12)
