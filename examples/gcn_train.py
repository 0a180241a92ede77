"""Train a 2-layer GCN with the planned SpMM engines under jax.grad.

End-to-end demonstration that crp_tpu is a *framework*, not just a kernel:
the graph propagation ``A_hat @ X`` runs through :class:`DifferentiableSpmm`
(planned sparsity-aware exchange + local kernel, exact custom VJP
``dX = A_hat^T @ dC``), composed with ordinary flax-free dense layers,
``optax`` and ``jit``.  The reference library stops at ``C = A @ B``
(``examples/test_rp_spmm.c:9-14``); this is the JAX surface above it.

Runs anywhere: one GPU, or the virtual CPU mesh:

  JAX_PLATFORMS=cpu \
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  python examples/gcn_train.py --nodes=2000 --steps=30 --p=4

The synthetic task: community power-law graph (the reference's social-graph
class), features = noisy community indicators, labels = community ids.
A 2-layer GCN must beat a feature-only linear probe by using ``A_hat``.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def normalized_adjacency(a):
    """GCN-normalized A_hat = D^-1/2 (A + I) D^-1/2 as a CSRMatrix."""
    from crp_tpu.sparse.csr import CSRMatrix

    rows = np.repeat(np.arange(a.nrow, dtype=np.int64), np.diff(a.rowptr))
    rows = np.concatenate([rows, np.arange(a.nrow, dtype=np.int64)])
    cols = np.concatenate([a.colidx.astype(np.int64),
                           np.arange(a.nrow, dtype=np.int64)])
    vals = np.concatenate([np.abs(a.val), np.ones(a.nrow)])
    deg = np.zeros(a.nrow)
    np.add.at(deg, rows, vals)
    d = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
    return CSRMatrix.from_coo(
        a.nrow, a.ncol, rows, cols, vals * d[rows] * d[cols]
    )


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=2000)
    ap.add_argument("--classes", type=int, default=8)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--p", type=int, default=4, help="devices (pm shards)")
    ap.add_argument("--kernel", default="segsum",
                    help="auto|segsum|ell|triton")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import optax

    from crp_tpu.config import SpmmConfig
    from crp_tpu.engine.autodiff import DifferentiableSpmm
    from crp_tpu.plan.partition1d import csr_row_partition
    from crp_tpu.shard.layout import make_mesh_1d
    from crp_tpu.sparse.synth import powerlaw_community_csr

    nn, k = args.nodes, args.classes
    a = powerlaw_community_csr(nn, avg_degree=8, comm_size=nn // k, seed=5)
    ah = normalized_adjacency(a)

    # features: noisy one-hot community indicator; labels: community id
    rng = np.random.default_rng(6)
    comm = np.minimum(np.arange(nn) // (nn // k), k - 1)
    x = np.eye(k, dtype=np.float32)[comm] + 0.5 * rng.standard_normal(
        (nn, k)
    ).astype(np.float32)
    y = jnp.asarray(comm)

    # two propagation widths -> two planned op instances (static shapes)
    displs = csr_row_partition(ah.rowptr, args.p)
    mesh = make_mesh_1d(args.p)
    cfg = SpmmConfig(kernel=args.kernel)
    prop_in = DifferentiableSpmm(ah, displs, displs, k, mesh=mesh, config=cfg)
    prop_h = DifferentiableSpmm(
        ah, displs, displs, args.hidden, mesh=mesh, config=cfg
    )

    xs = prop_in.shard_b(x)
    m_rows = int(np.asarray(prop_in.op(xs)).shape[1])  # padded C rows

    def unpad(cs, width):
        # (p, rows, width) shards -> (nodes, width) rows via the A displs
        parts = [cs[i, : int(displs[i + 1] - displs[i])]
                 for i in range(args.p)]
        out = jnp.concatenate(parts, axis=0)
        return jnp.pad(out, ((0, nn - out.shape[0]), (0, 0)))

    def repad(xg, rows):
        # (nodes, width) -> (p, rows, width) shards in the B displs layout
        parts = [xg[int(displs[i]): int(displs[i + 1])] for i in range(args.p)]
        h = max(int(displs[i + 1] - displs[i]) for i in range(args.p))
        parts = [jnp.pad(q, ((0, rows - q.shape[0]), (0, 0))) for q in parts]
        return jnp.stack(parts)

    w_key = jax.random.PRNGKey(0)
    params = {
        "w1": jax.random.normal(w_key, (k, args.hidden)) * 0.3,
        "w2": jax.random.normal(jax.random.PRNGKey(1),
                                (args.hidden, k)) * 0.3,
    }
    opt = optax.adam(3e-2)
    opt_state = opt.init(params)

    in_rows = int(xs.shape[1])
    h_rows = int(prop_h.fwd.max_k)

    def model(params, xs_):
        h = unpad(prop_in.op(xs_), k) @ params["w1"]          # A_hat X W1
        h = jax.nn.relu(h)
        h2 = prop_h.op(repad(h, h_rows))                       # A_hat H
        return unpad(h2, args.hidden) @ params["w2"]           # logits

    def loss_fn(params, xs_, y_):
        logits = model(params, xs_)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y_
        ).mean()

    @jax.jit
    def step(params, opt_state, xs_, y_):
        loss, g = jax.value_and_grad(loss_fn)(params, xs_, y_)
        updates, opt_state = opt.update(g, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    for i in range(args.steps):
        params, opt_state, loss = step(params, opt_state, xs, y)
        if i % 5 == 0 or i == args.steps - 1:
            acc = float(
                (jnp.argmax(model(params, xs), -1) == y).mean()
            )
            print(f"step {i:3d}  loss {float(loss):.4f}  acc {acc:.3f}",
                  flush=True)
    acc = float((jnp.argmax(model(params, xs), -1) == y).mean())
    print(f"final accuracy {acc:.3f} on {nn} nodes "
          f"({args.p} shards, kernel={prop_in.fwd.kernel_kind})")
    return 0 if acc > 0.7 else 1


if __name__ == "__main__":
    raise SystemExit(main())
