"""Per-window mean losses of bench_ctr's recipe on the CPU, through the
JAX package or its PyTorch port.

    JAX_PLATFORMS=cpu python tools/ctr_window_losses.py --package ref
    python tools/ctr_window_losses.py --package port

The recipe is ``benchmarks/run_all.py``'s bench_ctr at its accelerator
sizes (vocab 2,000,000, dim 64, 16 slots, batch 1024, hidden (512, 256),
k 16, capacity 2^18, sparse SGD 0.05, dense Adam(1e-3), Zipf-1.2 ids of
seed 3, (windows + 1) * k batches), trained through ``train_ctr_windows``
with prefetch off on a server on port 0. Dense weights come from each
package's own ``seed(0)``, so the two runs start from different weights;
the trend of the window means is what compares.
"""
import argparse
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package", choices=("port", "ref"), required=True)
    ap.add_argument("--windows", type=int, default=10)
    args = ap.parse_args()
    vocab, dim, slots, batch, hidden, k = (2_000_000, 64, 16, 1024,
                                           (512, 256), 16)
    if args.package == "port":
        import torch
        torch.set_num_threads(4)
        import paddle_tpu_torch as pkg
        from paddle_tpu_torch.distributed import ps
        from paddle_tpu_torch.distributed.ps.communicator import \
            SyncCommunicator
        from paddle_tpu_torch.models import ctr
        kw = {"device": "cpu"}
    else:
        import jax
        jax.config.update("jax_platforms", "cpu")
        import paddle_tpu as pkg
        from paddle_tpu.distributed import ps
        from paddle_tpu.distributed.ps.communicator import SyncCommunicator
        from paddle_tpu.models import ctr
        kw = {}
    t0 = time.perf_counter()
    batches = ctr.synthetic_ctr_batches((args.windows + 1) * k,
                                        batch_size=batch, slots=slots,
                                        vocab=vocab, seed=3)
    tables = [ps.TableConfig(1000, "sparse", dim, "sgd", lr=0.05,
                             init_range=0.05, seed=1000),
              ps.TableConfig(1001, "sparse", 1, "sgd", lr=0.05,
                             init_range=0.05, seed=1001)]
    srv = ps.PsServer(tables, port=0)
    cli = ps.PsClient([f"127.0.0.1:{srv.start()}"])
    wb = ps.WriteBackQueue(cli)
    try:
        pkg.seed(0)
        model = ctr.WideAndDeep(vocab, dim=dim, slots=slots, hidden=hidden,
                                cached=True, capacity=1 << 18,
                                optimizer="sgd", lr=0.05, writeback=wb,
                                **kw)
        ps.bind_model(model, SyncCommunicator(cli, n_workers=1))
        opt = pkg.optimizer.Adam(parameters=model.parameters(),
                                 learning_rate=0.001)
        r = ctr.train_ctr_windows(model, opt, batches, k=k, prefetch=False,
                                  flush=True)
    finally:
        wb.stop(flush=False)
        cli.stop_servers()
        srv.stop()
    losses = np.asarray(r["losses"])
    means = [float(losses[i:i + k].mean()) for i in range(0, losses.size, k)]
    print(f"{args.package}: {r['windows']} windows, mean loss a window: "
          + " ".join(f"{m:.4f}" for m in means)
          + f" ({time.perf_counter() - t0:.1f} s)")


if __name__ == "__main__":
    main()
