"""Train a 2-layer graph attention network (GAT) with trainable edge weights.

Companion to ``examples/gcn_train.py``: where the GCN demonstrates
:class:`DifferentiableSpmm` (static A, gradients to B), this exercises the
full trainable surface of :class:`~crp_tpu.engine.trainable.ValueParameterizedSpmm`:

  * attention scores per edge via the **SDDMM primitive** (``vps.sddmm`` —
    sampled ``X @ Y^T`` at A's sparsity pattern, routed through the same
    planned sparsity-aware B-row exchange as an SpMM exec,
    ``src/rowpara_spmm.c:152-165`` analog),
  * per-row (per-destination) segment softmax over the (nnz,) score
    vector — host-static row ids, so it is plain ``jax.ops.segment_*``,
  * the propagation ``C = A(alpha) @ (H W)`` through ``vps.op`` whose
    custom VJP returns exact cotangents for BOTH the dense input
    (``dB = A(alpha)^T @ dC``) and the edge values (an SDDMM) — so
    gradients reach W and the attention vectors through the edge weights.

The reference library computes ``C = A @ B`` with static A values
(``examples/test_rp_spmm.c:9-14``); a trainable-adjacency network on top of
the planned engines is JAX framework surface beyond it.

Runs anywhere: one GPU, or the virtual CPU mesh:

  JAX_PLATFORMS=cpu \
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  python examples/gat_train.py --nodes=2000 --steps=30 --p=4

Task: community power-law graph (the reference's social-graph class),
features = noisy community indicators, labels = community ids; attention
must learn to favor intra-community edges.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pattern_with_self_loops(a):
    """A + I as a pattern-only CSRMatrix (values 1.0) — GAT attends over
    each vertex's neighborhood including itself."""
    from crp_tpu.sparse.csr import CSRMatrix

    rows = np.repeat(np.arange(a.nrow, dtype=np.int64), np.diff(a.rowptr))
    rows = np.concatenate([rows, np.arange(a.nrow, dtype=np.int64)])
    cols = np.concatenate([a.colidx.astype(np.int64),
                           np.arange(a.nrow, dtype=np.int64)])
    return CSRMatrix.from_coo(
        a.nrow, a.ncol, rows, cols, np.ones(rows.shape[0])
    )


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=2000)
    ap.add_argument("--classes", type=int, default=8)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--p", type=int, default=4, help="devices (pm shards)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import optax

    from crp_tpu.engine.trainable import ValueParameterizedSpmm
    from crp_tpu.plan.partition1d import csr_row_partition
    from crp_tpu.shard.layout import make_mesh_1d
    from crp_tpu.sparse.synth import powerlaw_community_csr

    nn, k = args.nodes, args.classes
    g = powerlaw_community_csr(nn, avg_degree=8, comm_size=nn // k, seed=5)
    ah = pattern_with_self_loops(g)
    # host-static edge lists (A's CSR order — the vps value-slot order)
    rows_g = jnp.asarray(
        np.repeat(np.arange(nn, dtype=np.int32), np.diff(ah.rowptr))
    )

    rng = np.random.default_rng(6)
    comm = np.minimum(np.arange(nn) // (nn // k), k - 1)
    x = np.eye(k, dtype=np.float32)[comm] + 0.5 * rng.standard_normal(
        (nn, k)
    ).astype(np.float32)
    y = jnp.asarray(comm)

    displs = csr_row_partition(ah.rowptr, args.p)
    mesh = make_mesh_1d(args.p)
    # one planned instance per propagation width (static shapes)
    vps_h = ValueParameterizedSpmm(ah, displs, displs, args.hidden, mesh=mesh)
    vps_o = ValueParameterizedSpmm(ah, displs, displs, k, mesh=mesh)

    m_pad = int(vps_h.fwd.max_m)   # row-shard padding (C/X rows)
    k_pad = int(vps_h.fwd.max_k)   # ownership-shard padding (B/Y rows)

    def repad(xg, rows):
        """(nodes, w) global -> (p, rows, w) shards along the row displs."""
        parts = [xg[int(displs[i]): int(displs[i + 1])] for i in range(args.p)]
        parts = [jnp.pad(q, ((0, rows - q.shape[0]), (0, 0))) for q in parts]
        return jnp.stack(parts)

    def unpad(cs):
        """(p, rows, w) shards -> (nodes, w) global along the row displs."""
        parts = [cs[i, : int(displs[i + 1] - displs[i])]
                 for i in range(args.p)]
        return jnp.concatenate(parts, axis=0)

    def gat_layer(vps, h, w, a_src, a_dst):
        """One attention head: softmax_j(LeakyReLU(s_i + d_j)) A(alpha) HW."""
        hw = h @ w                                   # (nodes, width)
        s, d = hw @ a_src, hw @ a_dst                # (nodes,)
        # e_q = s[row_q] + d[col_q] as a rank-2 SDDMM: dot([s,1],[1,d])
        ones = jnp.ones_like(s)
        e = vps.sddmm(
            repad(jnp.stack([s, ones], 1), m_pad),
            repad(jnp.stack([ones, d], 1), k_pad),
        )
        e = jax.nn.leaky_relu(e, 0.2)
        # per-destination-row softmax over the (nnz,) scores
        emax = jax.ops.segment_max(
            e, rows_g, num_segments=nn, indices_are_sorted=True
        )
        ex = jnp.exp(e - emax[rows_g])
        den = jax.ops.segment_sum(
            ex, rows_g, num_segments=nn, indices_are_sorted=True
        )
        alpha = ex / jnp.maximum(den[rows_g], 1e-12)
        return unpad(vps.op(repad(hw, k_pad), alpha))

    kb = jax.random.PRNGKey
    params = {
        "w1": jax.random.normal(kb(0), (k, args.hidden)) * 0.3,
        "a1s": jax.random.normal(kb(1), (args.hidden,)) * 0.3,
        "a1d": jax.random.normal(kb(2), (args.hidden,)) * 0.3,
        "w2": jax.random.normal(kb(3), (args.hidden, k)) * 0.3,
        "a2s": jax.random.normal(kb(4), (k,)) * 0.3,
        "a2d": jax.random.normal(kb(5), (k,)) * 0.3,
    }
    opt = optax.adam(2e-2)
    opt_state = opt.init(params)
    xg = jnp.asarray(x)

    def model(params, xg_):
        h = gat_layer(vps_h, xg_, params["w1"], params["a1s"], params["a1d"])
        h = jax.nn.elu(h)
        return gat_layer(vps_o, h, params["w2"], params["a2s"], params["a2d"])

    def loss_fn(params, xg_, y_):
        return optax.softmax_cross_entropy_with_integer_labels(
            model(params, xg_), y_
        ).mean()

    @jax.jit
    def step(params, opt_state, xg_, y_):
        loss, grad = jax.value_and_grad(loss_fn)(params, xg_, y_)
        updates, opt_state = opt.update(grad, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    for i in range(args.steps):
        params, opt_state, loss = step(params, opt_state, xg, y)
        if i % 5 == 0 or i == args.steps - 1:
            acc = float((jnp.argmax(model(params, xg), -1) == y).mean())
            print(f"step {i:3d}  loss {float(loss):.4f}  acc {acc:.3f}",
                  flush=True)
    acc = float((jnp.argmax(model(params, xg), -1) == y).mean())
    print(f"final accuracy {acc:.3f} on {nn} nodes "
          f"({args.p} shards, {ah.nnz} edges, single-head GAT)")
    return 0 if acc > 0.7 else 1


if __name__ == "__main__":
    raise SystemExit(main())
