"""Parameter-server training (counterpart:
``paddle_tpu/distributed/ps/__init__.py``; the reference framework's brpc
PS stack — `distributed/service/`, `distributed/table/`,
`fleet/runtime/the_one_ps.py`, `operators/pscore/`).

Design: the table store and TCP service are native C++
(``_native/src/ps_service.cc``, built with g++ at first use); workers
drive eager training with ``SparseEmbedding`` lookups against the servers
and a Communicator (sync / async / geo) that mirrors
`communicator.h:197-497`. The dense forward and backward run in torch on
the worker's device (the card unless the model was built on the CPU); only
the parameter exchange rides host sockets. ``CachedSparseEmbedding`` serves
a table from a device-resident cache (``hbm_cache``) with a prefetch and
write-back pipeline (``async_cache``).

Typical flow (mirrors reference fleet PS usage):

    role = role_maker.PaddleCloudRoleMaker(is_collective=False)
    fleet.init(role, strategy=s)           # s.a_sync / a_sync_configs
    if fleet.is_server():
        fleet.init_server(model); fleet.run_server()
    else:
        model = build()                    # uses ps.SparseEmbedding
        fleet.init_worker(model)
        ... loss.backward(); opt.step() [geo] ...; fleet.ps_step(opt)
        fleet.stop_worker()

Not ported: ``heter.py`` (``HeterClient``, ``HeterServer``,
``start_heter_server``) and ``graph.py`` (``GraphPsClient``; the native
service already holds the graph tables).
"""
from .client import PsClient
from .communicator import (AsyncCommunicator, GeoCommunicator,
                           SyncCommunicator)
from .embedding import (SparseEmbedding, distributed_lookup_table,
                        flush_sparse_grads, reset_registry, sparse_tables)
from .server import OPT_ADAM, OPT_SGD, OPT_SUM, PsServer, TableConfig
from .trainer import DownpourTrainer, DownpourWorker  # noqa: F401
from .hbm_cache import (CachedSparseEmbedding, HbmEmbeddingCache,  # noqa: F401
                        PsTpuTrainer)
from .async_cache import (CachePrefetcher, WindowPlan,  # noqa: F401
                          WriteBackQueue)


def bind_model(model, communicator, bind_embeddings=True):
    """Attach a model replica to a communicator: bind its SparseEmbedding
    layers and register every trainable dense parameter under sequential
    table ids. The ONE place that owns the dense-table-id-by-enumeration
    contract (server and every worker/replica must agree on it)."""
    if bind_embeddings:
        for sub in model.sublayers(include_self=True):
            if isinstance(sub, SparseEmbedding):
                sub.bind(communicator)
    dense_id = 0
    for p in model.parameters():
        if getattr(p, "trainable", p.requires_grad):
            communicator.register_dense_param(dense_id, p)
            dense_id += 1


class PsRuntime:
    """Per-process PS runtime (reference: TheOnePSRuntime the_one_ps.py:434).

    Servers: derive table configs (sparse tables from the constructed
    SparseEmbedding layers + dense slots for every registered dense param),
    start the native service. Workers: build the client + communicator,
    bind embeddings, register dense params, align initial values.
    """

    def __init__(self, role_maker, strategy):
        self.role = role_maker
        self.strategy = strategy
        self.server = None
        self.communicator = None
        self.client = None

    # -- mode -------------------------------------------------------------
    def _mode(self):
        if not getattr(self.strategy, "a_sync", False):
            return "sync"
        cfg = getattr(self.strategy, "a_sync_configs", {}) or {}
        return "geo" if cfg.get("k_steps", 0) > 0 else "async"

    def _server_opt(self):
        """Server-side rule for sync/async pushes; geo uses raw deltas."""
        cfg = getattr(self.strategy, "a_sync_configs", {}) or {}
        return (cfg.get("optimizer", "sgd"),
                float(cfg.get("learning_rate", 0.01)))

    # -- server side ------------------------------------------------------
    def init_server(self, model=None, port=None):
        opt_name, lr = self._server_opt()
        geo = self._mode() == "geo"
        tables = []
        for emb in sparse_tables():
            tables.append(TableConfig(
                emb.table_id, "sparse", emb.embedding_dim,
                optimizer="sum" if geo else opt_name, lr=lr,
                init_range=emb.init_range, seed=emb.table_id))
        n_dense = self._count_dense(model)
        for i in range(n_dense):
            tables.append(TableConfig(
                i, "dense", 0, optimizer="sum" if geo else opt_name, lr=lr))
        if port is None:
            ep = self.role.get_pserver_endpoints()[self.role.server_index()]
            port = int(ep.rsplit(":", 1)[1])
        self.server = PsServer(tables, port=port)
        self.server.start()
        return self.server

    @staticmethod
    def _count_dense(model):
        if model is None:
            # dense tables must exist before workers push (handlers never
            # create tables); 64 spare slots cover model-less bring-up but
            # a real model should be passed so the count is exact
            return 64
        return len([p for p in model.parameters()
                    if getattr(p, "trainable", p.requires_grad)])

    def run_server(self):
        self.server.run()

    # -- worker side ------------------------------------------------------
    def init_worker(self, model=None):
        eps = self.role.get_pserver_endpoints()
        self.client = PsClient(eps)
        mode = self._mode()
        n = self.role.worker_num()
        cfg = getattr(self.strategy, "a_sync_configs", {}) or {}
        if mode == "sync":
            self.communicator = SyncCommunicator(self.client, n_workers=n)
        elif mode == "async":
            self.communicator = AsyncCommunicator(
                self.client, n_workers=n,
                pull_every=int(cfg.get("pull_every", 1)))
        else:
            self.communicator = GeoCommunicator(
                self.client, n_workers=n,
                k_steps=int(cfg.get("k_steps", 4)),
                sparse_lr=float(cfg.get("learning_rate", 0.01)))
        for emb in sparse_tables():
            emb.bind(self.communicator)
        if model is not None:
            bind_model(model, self.communicator, bind_embeddings=False)
        self.communicator.init_params()
        # one init-barrier round for every worker: nobody may start pushing
        # step-0 grads before all workers adopted the initial params (keeps
        # barrier generations aligned — each worker makes the same sequence
        # of barrier calls)
        self.client.barrier(n, timeout=600.0)
        return self.communicator

    def step(self, optimizer=None):
        """Post-backward hook: route grads per the active mode."""
        flush_sparse_grads(self.communicator)
        local = self._mode() == "geo"
        if local and optimizer is not None:
            optimizer.step()
            optimizer.clear_grad()
        self.communicator.step(optimizer)
        if not local and optimizer is not None:
            optimizer.clear_grad()

    def stop_worker(self):
        if self.communicator is not None:
            self.communicator.stop()

    def shutdown_servers(self):
        if self.client is not None:
            self.client.stop_servers()

    def save_persistables(self, path_prefix):
        """Server-side table snapshot (reference: the_one_ps.py:815)."""
        self.client.save(path_prefix)

    def load_persistables(self, path_prefix):
        self.client.load(path_prefix)
