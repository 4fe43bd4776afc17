// paddle_tpu_torch native parameter-server service (libpaddle_tpu_torch_ps,
// built with pt_clock.cc by paddle_tpu_torch/_native/__init__.py). A copy of
// the JAX package's service: the same tables, rules and wire format, so the
// two packages' clients and servers interoperate byte for byte.
//
// TPU-native equivalent of the reference's brpc parameter-server runtime:
//   - dense / sparse tables      (reference: paddle/fluid/distributed/table/
//                                 common_dense_table.cc, common_sparse_table.cc)
//   - server-side optimizers     (reference: table/depends/dense.h, sparse.h —
//                                 sum / sgd / adam rules applied on the server)
//   - TCP service + handlers     (reference: distributed/service/
//                                 brpc_ps_server.cc; brpc replaced by a
//                                 length-prefixed binary protocol over
//                                 loopback/DCN sockets — the TPU pod's compute
//                                 collectives ride ICI, the PS path is host
//                                 networking exactly like the reference)
//   - geo delta application      (reference: service/communicator.h:497
//                                 GeoCommunicator — workers push param deltas,
//                                 the server accumulates them)
//   - table snapshots            (reference: the_one_ps.py:815 save_persistables)
//
// Wire format (little-endian):
//   request : u32 body_len | u32 magic("PTS1") | u8 op | u32 table | u64 n
//             | payload                         (body_len counts from magic)
//   response: u32 body_len | payload
// Trace context (Dapper-style propagation): an op byte with the high bit
// set (op | 0x80) prefixes its payload with `u64 trace_id | u64 span_id`
// — the caller's trace context. The flag is stripped before dispatch, so
// a traced call behaves (and is attributed in op_stats) exactly like its
// legacy twin; additionally the server records a service-side span
// (trace_id, parent = caller's span_id, own minted span_id, table, op,
// start/end ns on the shared CLOCK_MONOTONIC base) into a bounded ring
// exported by pt_ps_trace_json — the host-side half of a cross-process
// trace a client's run-log joins on the ids.
// The magic word doubles as a protocol version; it is read and checked
// BEFORE the body is allocated, so a stray peer (port collision, HTTP
// probe, garbage) cannot drive an attacker-controlled resize — the
// connection drops before any payload is interpreted or buffered.
// The Python client (paddle_tpu_torch/distributed/ps/client.py) shards sparse keys
// across servers by key % nservers and dense tables by table % nservers.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#define PT_API extern "C" __attribute__((visibility("default")))

namespace {

enum Op : uint8_t {
  kPullDense = 1,
  kPushDenseGrad = 2,
  kPullSparse = 3,
  kPushSparseGrad = 4,
  kPushSparseDelta = 5,
  kPushDenseDelta = 6,
  kBarrier = 7,
  kSave = 8,
  kLoad = 9,
  kStop = 10,
  kSparseSize = 11,
  kPullDenseInit = 12,  // pull, initializing from payload if first touch
  // request-id'd pushes: payload = u64 request_id | legacy payload. The
  // server remembers recently seen ids and replies ok without applying a
  // duplicate — a client may re-send a push whose response was lost
  // (retry with backoff) without the grad being applied twice. This is
  // what makes the push path idempotent, hence safely retriable.
  kPushDenseGradId = 13,
  kPushDenseDeltaId = 14,
  kPushSparseGradId = 15,
  kPushSparseDeltaId = 16,
  // drain the service-side trace-span ring over the wire (n != 0 drains,
  // n == 0 peeks): a client of a REMOTE server — one not sharing this
  // process, where pt_ps_trace_json is unreachable — collects the
  // server's spans into its own run-log (PsClient.drain_server_spans)
  kPullSpans = 17,
  // graph service (reference: common_graph_table.cc + graph_brpc_server.cc)
  kGraphAddNodes = 20,        // n ids | n*feat_dim f32 features
  kGraphAddEdges = 21,        // n src | n dst | n f32 weights
  kGraphSampleNeighbors = 22, // n ids | u32 k | u64 seed
  kGraphPullList = 23,        // u64 start | u64 count -> node id batch
  kGraphNodeFeat = 24,        // n ids -> n*feat_dim f32
  kGraphRandomNodes = 25,     // u32 k | u64 seed -> <=k ids
  kGraphSize = 26,            // -> u64 node count
  kSparseSpillInfo = 27,      // -> u64 in_mem_rows | u64 spilled_rows
};

enum OptKind : int32_t { kOptSum = 0, kOptSgd = 1, kOptAdam = 2 };

constexpr uint32_t kMagic = 0x31535450u;  // "PTS1"
constexpr uint32_t kMaxFrame = 1u << 30;  // 1 GiB frame cap (sanity bound)
constexpr uint8_t kTraceFlag = 0x80;      // op | 0x80 = traced request
constexpr size_t kTraceRingCap = 8192;    // bounded server-side span ring

struct OptConf {
  int32_t kind = kOptSgd;
  float lr = 0.01f;
  float beta1 = 0.9f, beta2 = 0.999f, eps = 1e-8f;
};

// splitmix64: deterministic per-key init so every shard/restart agrees
inline uint64_t mix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ull;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
  return x ^ (x >> 31);
}

struct SparseTable {
  int dim = 0;
  OptConf opt;
  float init_range = 0.0f;
  uint64_t seed = 0;
  // row layout: param[dim] | m[dim] | v[dim] (m/v only for adam)
  std::unordered_map<uint64_t, std::vector<float>> rows;
  std::unordered_map<uint64_t, int64_t> steps;  // adam t per row
  std::mutex mu;

  // Out-of-core spill (reference: table/ssd_sparse_table.cc — cold rows
  // behind the in-memory map; rocksdb replaced by a fixed-record file +
  // free-slot index, which a restartable PS on one host is all it needs).
  uint64_t budget = 0;  // max in-memory rows; 0 = RAM-only
  std::string spill_path;
  FILE* spill_f = nullptr;
  std::unordered_map<uint64_t, uint64_t> spill_off;  // key -> record slot
  std::vector<uint64_t> free_slots;
  uint64_t spill_slots = 0;
  std::unordered_map<uint64_t, uint64_t> last_use;
  uint64_t tick = 0;
  uint64_t spill_failures = 0;  // surfaced via kSparseSpillInfo
  bool spill_broken = false;    // a full evict batch failed: stop paying
                                // the O(rows) scan per insert

  SparseTable() = default;
  SparseTable(const SparseTable&) = delete;
  SparseTable& operator=(const SparseTable&) = delete;
  ~SparseTable() {
    if (spill_f) fclose(spill_f);
  }

  int row_len() const { return opt.kind == kOptAdam ? 3 * dim : dim; }
  size_t rec_bytes() const { return 16 + 4ull * row_len(); }

  bool ensure_file() {
    if (spill_f) return true;
    if (spill_path.empty()) return false;
    spill_f = fopen(spill_path.c_str(), "w+b");
    return spill_f != nullptr;
  }

  // Returns false WITHOUT touching the in-memory row on any I/O
  // failure — a failed spill must never destroy trained state (the row
  // just stays resident; the budget is soft under disk errors).
  bool spill_one(uint64_t key) {
    auto it = rows.find(key);
    if (it == rows.end()) return false;
    if (!ensure_file()) {
      ++spill_failures;
      return false;
    }
    uint64_t slot;
    if (!free_slots.empty()) {
      slot = free_slots.back();
      free_slots.pop_back();
    } else {
      slot = spill_slots++;
    }
    int64_t st = 0;
    auto sit = steps.find(key);
    if (sit != steps.end()) st = sit->second;
    bool wok =
        fseeko(spill_f, (off_t)(slot * rec_bytes()), SEEK_SET) == 0 &&
        fwrite(&key, 8, 1, spill_f) == 1 &&
        fwrite(&st, 8, 1, spill_f) == 1 &&
        fwrite(it->second.data(), 4, row_len(), spill_f) ==
            (size_t)row_len() &&
        fflush(spill_f) == 0;  // catches ENOSPC before the row is erased
    if (!wok) {
      ++spill_failures;
      free_slots.push_back(slot);
      return false;
    }
    spill_off[key] = slot;
    rows.erase(it);
    steps.erase(key);
    last_use.erase(key);
    return true;
  }

  bool read_spilled(uint64_t slot, uint64_t* key, int64_t* st,
                    float* vals) {
    fseeko(spill_f, (off_t)(slot * rec_bytes()), SEEK_SET);
    return fread(key, 8, 1, spill_f) == 1 &&
           fread(st, 8, 1, spill_f) == 1 &&
           fread(vals, 4, row_len(), spill_f) == (size_t)row_len();
  }

  bool fault_from_spill(uint64_t key) {
    auto it = spill_off.find(key);
    if (it == spill_off.end()) return false;
    uint64_t k2;
    int64_t st;
    std::vector<float> vals(row_len());
    if (!read_spilled(it->second, &k2, &st, vals.data())) {
      // unreadable record: drop the stale index entry so the key never
      // lives in both maps (double-counted sizes, duplicate snapshot
      // rows, stale adam steps on load)
      ++spill_failures;
      free_slots.push_back(it->second);
      spill_off.erase(it);
      return false;
    }
    rows.emplace(key, std::move(vals));
    if (st) steps[key] = st;
    free_slots.push_back(it->second);
    spill_off.erase(it);
    return true;
  }

  // Batch eviction of the coldest rows down to 3/4 of the budget —
  // amortizes the O(in-mem) age scan (the reference's shard-wise
  // cache-threshold pass, ssd_sparse_table.cc Flush/Shrink).
  void maybe_evict() {
    if (!budget || spill_broken || rows.size() <= budget) return;
    size_t target = budget - budget / 4;
    if (target == 0) target = 1;
    size_t n_evict = rows.size() - target;
    std::vector<std::pair<uint64_t, uint64_t>> ages;  // (last_use, key)
    ages.reserve(rows.size());
    for (auto& kv : rows) {
      auto lu = last_use.find(kv.first);
      ages.emplace_back(lu == last_use.end() ? 0 : lu->second, kv.first);
    }
    std::nth_element(ages.begin(), ages.begin() + n_evict, ages.end());
    size_t done = 0;
    for (size_t i = 0; i < n_evict; ++i)
      if (spill_one(ages[i].second)) ++done;
    if (done == 0) {
      // every write failed (bad path / full disk): keep serving from RAM
      // but stop re-scanning per insert; the failure count tells on us
      spill_broken = true;
      fprintf(stderr,
              "[paddle_tpu ps] sparse spill to '%s' is failing; table "
              "continues RAM-only (budget not enforced)\n",
              spill_path.c_str());
    }
  }

  std::vector<float>& row(uint64_t key) {
    if (budget) last_use[key] = ++tick;
    auto it = rows.find(key);
    if (it != rows.end()) return it->second;
    if (budget && fault_from_spill(key)) {
      maybe_evict();  // only evicts colder keys; this ref stays valid
      return rows.find(key)->second;
    }
    std::vector<float> r(row_len(), 0.0f);
    if (init_range > 0.0f) {
      for (int i = 0; i < dim; ++i) {
        uint64_t h = mix64(seed ^ mix64(key * 1315423911ull + i));
        float u = (h >> 11) * (1.0f / 9007199254740992.0f);  // [0,1)
        r[i] = (2.0f * u - 1.0f) * init_range;
      }
    }
    auto& ref = rows.emplace(key, std::move(r)).first->second;
    maybe_evict();
    return ref;
  }

  void apply_grad(uint64_t key, const float* g) {
    std::vector<float>& r = row(key);
    switch (opt.kind) {
      case kOptSum:
        for (int i = 0; i < dim; ++i) r[i] += g[i];
        break;
      case kOptSgd:
        for (int i = 0; i < dim; ++i) r[i] -= opt.lr * g[i];
        break;
      case kOptAdam: {
        int64_t t = ++steps[key];
        float* p = r.data();
        float* m = p + dim;
        float* v = p + 2 * dim;
        float bc1 = 1.0f - std::pow(opt.beta1, (float)t);
        float bc2 = 1.0f - std::pow(opt.beta2, (float)t);
        for (int i = 0; i < dim; ++i) {
          m[i] = opt.beta1 * m[i] + (1.0f - opt.beta1) * g[i];
          v[i] = opt.beta2 * v[i] + (1.0f - opt.beta2) * g[i] * g[i];
          p[i] -= opt.lr * (m[i] / bc1) / (std::sqrt(v[i] / bc2) + opt.eps);
        }
        break;
      }
    }
  }
};

struct DenseTable {
  int dim = 0;
  OptConf opt;
  std::vector<float> param, m, v;
  int64_t t = 0;
  bool initialized = false;
  std::mutex mu;

  // Grows only from empty: a size mismatch against a live table is a
  // client bug, and silently re-zeroing would destroy trained state —
  // the caller replies ok=0 so the client raises.
  bool ensure(size_t n) {
    if (param.empty() && n > 0)
      param.assign(n, 0.0f);
    else if (param.size() != n)
      return false;
    if (opt.kind == kOptAdam && m.size() != param.size()) {
      m.assign(param.size(), 0.0f);
      v.assign(param.size(), 0.0f);
    }
    return true;
  }

  bool apply_grad(const float* g, int n) {
    if (!ensure(n)) return false;
    switch (opt.kind) {
      case kOptSum:
        for (int i = 0; i < n; ++i) param[i] += g[i];
        break;
      case kOptSgd:
        for (int i = 0; i < n; ++i) param[i] -= opt.lr * g[i];
        break;
      case kOptAdam: {
        ++t;
        float bc1 = 1.0f - std::pow(opt.beta1, (float)t);
        float bc2 = 1.0f - std::pow(opt.beta2, (float)t);
        for (int i = 0; i < n; ++i) {
          m[i] = opt.beta1 * m[i] + (1.0f - opt.beta1) * g[i];
          v[i] = opt.beta2 * v[i] + (1.0f - opt.beta2) * g[i] * g[i];
          param[i] -= opt.lr * (m[i] / bc1) / (std::sqrt(v[i] / bc2) + opt.eps);
        }
        break;
      }
    }
    return true;
  }
};

// Graph table shard (reference: table/common_graph_table.{h,cc} GraphShard
// buckets + FeatureNode; features here are fixed-dim f32 vectors — the
// TPU-friendly layout — instead of the reference's typed string features).
struct GraphNode {
  std::vector<uint64_t> nbr;
  std::vector<float> w;
  std::vector<float> feat;
};

struct GraphTable {
  int feat_dim = 0;
  std::unordered_map<uint64_t, GraphNode> nodes;
  std::vector<uint64_t> order;  // insertion order, for pull_graph_list
  std::mutex mu;

  GraphNode& node(uint64_t id) {
    auto it = nodes.find(id);
    if (it != nodes.end()) return it->second;
    order.push_back(id);
    GraphNode& n = nodes[id];
    n.feat.assign(feat_dim, 0.0f);
    return n;
  }
};

// Deterministic per-node sampling rng: every shard/restart/client agrees
// (reference seeds per-thread rng pools; determinism is a test contract
// here). xorshift64 seeded from mix64(seed ^ mix64(node_id)).
struct SampleRng {
  uint64_t s;
  explicit SampleRng(uint64_t seed) : s(seed ? seed : 0x9e3779b97f4a7c15ull) {}
  uint64_t next() {
    s ^= s << 13;
    s ^= s >> 7;
    s ^= s << 17;
    return s;
  }
};

struct Barrier {
  std::mutex mu;
  std::condition_variable cv;
  int arrived = 0;
  int64_t generation = 0;
};

// monotonic clock shared with the host profiler (pt_clock.cc): server
// spans land on the same time base as client spans, so a same-host
// trace merge needs no alignment
extern "C" long long pt_prof_now_ns();

// one service-side span: the caller's (trace, span) context + the
// server's own minted span id, the handled (table, op), and the
// frame-parsed -> response-sent window
struct TraceSpan {
  uint64_t trace = 0, parent = 0, span = 0;
  uint32_t table = 0;
  uint8_t op = 0;
  uint8_t dup = 0;  // request-id dedup answered without applying
  int64_t t0 = 0, t1 = 0;
};

struct PsServer {
  std::unordered_map<uint32_t, SparseTable> sparse;
  std::unordered_map<uint32_t, DenseTable> dense;
  std::unordered_map<uint32_t, GraphTable> graph;
  Barrier barrier;
  int listen_fd = -1;
  int port = 0;
  std::atomic<bool> running{false};
  std::thread accept_thread;
  std::vector<std::thread> conns;
  std::vector<int> conn_fds;  // parallel to conns; -1 once the handler
                              // has closed its socket (guarded by conns_mu)
  std::mutex conns_mu;
  // per-(table, op) service-side latency: calls + total ns spent from
  // frame-parsed to response-sent (the reference's per-table pserver
  // profiler vars). Ordered map -> stable pt_ps_stats_json output.
  struct OpStat {
    uint64_t calls = 0;
    uint64_t ns = 0;
  };
  std::map<uint64_t, OpStat> op_stats;  // key = table << 8 | op
  std::mutex stats_mu;
  // push request-id dedup: a bounded FIFO window of recently seen ids
  // (64K ids ~= far more in-flight pushes than any worker fleet holds;
  // an id evicted from the window can only be re-applied if a client
  // retries a push 64K pushes later, which the per-call deadline makes
  // impossible in practice). Value = has the apply FINISHED (vs merely
  // started) — a duplicate is only acked once its original completed.
  std::unordered_map<uint64_t, bool> seen_reqs;
  std::deque<uint64_t> seen_order;
  std::mutex seen_mu;
  std::condition_variable seen_cv;
  uint64_t dup_requests = 0;  // observability: how often dedup saved us
  // bounded ring of service-side spans for traced requests (oldest
  // dropped), drained by pt_ps_trace_json
  std::deque<TraceSpan> trace_ring;
  std::mutex trace_mu;
  std::atomic<uint64_t> span_seq{0};
};

void record_trace_span(PsServer* ps, uint64_t trace, uint64_t parent,
                       uint32_t table, uint8_t op, bool dup, int64_t t0) {
  TraceSpan s;
  s.trace = trace;
  s.parent = parent;
  s.t0 = t0;
  s.t1 = pt_prof_now_ns();
  // minted server span id: unique across handlers/restarts within a run
  s.span = mix64(trace ^ mix64(ps->span_seq.fetch_add(1) + 1) ^
                 (uint64_t)s.t1);
  s.table = table;
  s.op = op;
  s.dup = dup ? 1 : 0;
  std::lock_guard<std::mutex> lk(ps->trace_mu);
  if (ps->trace_ring.size() >= kTraceRingCap) ps->trace_ring.pop_front();
  ps->trace_ring.push_back(s);
}

// one span as a JSON object, appended to `s` (shared by the in-process
// pt_ps_trace_json export and the kPullSpans wire handler)
void append_span_json(std::string& s, const TraceSpan& sp, bool first) {
  char buf[256];
  snprintf(buf, sizeof(buf),
           "%s{\"trace\":%llu,\"parent\":%llu,\"span\":%llu,"
           "\"table\":%u,\"op\":%u,\"dup\":%u,\"t0\":%lld,"
           "\"t1\":%lld}",
           first ? "" : ",", (unsigned long long)sp.trace,
           (unsigned long long)sp.parent, (unsigned long long)sp.span,
           sp.table, (unsigned)sp.op, (unsigned)sp.dup,
           (long long)sp.t0, (long long)sp.t1);
  s += buf;
}

constexpr size_t kSeenReqWindow = 1u << 16;

enum ReqCheck : int {
  kReqNew = 0,       // marked in-progress; caller must apply + finish
  kReqDupDone = 1,   // duplicate of a completed apply: ack without apply
  kReqDupFailed = 2, // original was rejected (or dup wait timed out):
                     // reply ok=0 so the client surfaces the failure
};

// Dedup marks the id before the apply runs (check-and-insert), so a
// retry racing a still-running original (client socket timeout while
// the apply stalls behind a table mutex/OP_SAVE) can never apply twice.
// The duplicate then WAITS for the original to finish before acking —
// an ok=1 must imply the push is visible to a subsequent pull
// (read-your-writes), not merely scheduled. A rejected original
// (deterministic ok=0: table missing / size mismatch) erases its id, so
// its duplicate reports the same failure instead of a fake ok.
int check_request(PsServer* ps, uint64_t id) {
  std::unique_lock<std::mutex> lk(ps->seen_mu);
  auto it = ps->seen_reqs.find(id);
  if (it == ps->seen_reqs.end()) {
    ps->seen_reqs.emplace(id, false);
    ps->seen_order.push_back(id);
    if (ps->seen_order.size() > kSeenReqWindow) {
      ps->seen_reqs.erase(ps->seen_order.front());
      ps->seen_order.pop_front();
    }
    return kReqNew;
  }
  ++ps->dup_requests;
  bool signalled = ps->seen_cv.wait_for(
      lk, std::chrono::seconds(120), [&] {
        auto it2 = ps->seen_reqs.find(id);
        return it2 == ps->seen_reqs.end() || it2->second ||
               !ps->running.load();
      });
  auto it2 = ps->seen_reqs.find(id);
  if (signalled && it2 != ps->seen_reqs.end() && it2->second)
    return kReqDupDone;
  return kReqDupFailed;
}

void finish_request(PsServer* ps, uint64_t id, bool applied) {
  std::lock_guard<std::mutex> lk(ps->seen_mu);
  auto it = ps->seen_reqs.find(id);
  if (it != ps->seen_reqs.end()) {
    if (applied) {
      it->second = true;
    } else {
      ps->seen_reqs.erase(it);
      for (auto oit = ps->seen_order.rbegin();
           oit != ps->seen_order.rend(); ++oit) {
        if (*oit == id) {  // newest occurrence: just-inserted id
          ps->seen_order.erase(std::next(oit).base());
          break;
        }
      }
    }
  }
  ps->seen_cv.notify_all();
}

PsServer* g_ps = nullptr;
std::mutex g_ps_mu;

SparseTable* find_sparse(PsServer* ps, uint32_t table) {
  auto it = ps->sparse.find(table);  // registration happens before start;
  return it == ps->sparse.end() ? nullptr : &it->second;  // never insert here
}

DenseTable* find_dense(PsServer* ps, uint32_t table) {
  auto it = ps->dense.find(table);
  return it == ps->dense.end() ? nullptr : &it->second;
}

GraphTable* find_graph(PsServer* ps, uint32_t table) {
  auto it = ps->graph.find(table);
  return it == ps->graph.end() ? nullptr : &it->second;
}

bool read_all(int fd, void* buf, size_t n) {
  char* p = (char*)buf;
  while (n > 0) {
    ssize_t r = ::read(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= (size_t)r;
  }
  return true;
}

bool write_all(int fd, const void* buf, size_t n) {
  const char* p = (const char*)buf;
  while (n > 0) {
    ssize_t r = ::write(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= (size_t)r;
  }
  return true;
}

bool send_resp(int fd, const void* payload, uint32_t n) {
  if (!write_all(fd, &n, 4)) return false;
  return n == 0 || write_all(fd, payload, n);
}

bool save_tables(PsServer* ps, const std::string& path) {
  // write to a sidecar and publish via rename: a failed/interrupted
  // save (disk full, client timeout killing the conn mid-write) must
  // never destroy an existing good snapshot at `path`
  const std::string tmp = path + ".tmp";
  FILE* f = fopen(tmp.c_str(), "wb");
  if (!f) return false;
  uint32_t nd = ps->dense.size(), nsp = ps->sparse.size();
  fwrite(&nd, 4, 1, f);
  fwrite(&nsp, 4, 1, f);
  for (auto& kv : ps->dense) {
    DenseTable& t = kv.second;
    std::lock_guard<std::mutex> lk(t.mu);
    uint32_t id = kv.first, n = t.param.size();
    uint32_t has_mv = t.opt.kind == kOptAdam && !t.m.empty();
    fwrite(&id, 4, 1, f);
    fwrite(&n, 4, 1, f);
    fwrite(&has_mv, 4, 1, f);
    fwrite(&t.t, 8, 1, f);
    fwrite(t.param.data(), 4, n, f);
    if (has_mv) {
      fwrite(t.m.data(), 4, n, f);
      fwrite(t.v.data(), 4, n, f);
    }
  }
  for (auto& kv : ps->sparse) {
    SparseTable& t = kv.second;
    std::lock_guard<std::mutex> lk(t.mu);
    uint32_t id = kv.first;
    uint64_t rows = t.rows.size() + t.spill_off.size();
    uint32_t rl = t.row_len();
    fwrite(&id, 4, 1, f);
    fwrite(&rows, 8, 1, f);
    fwrite(&rl, 4, 1, f);
    for (auto& r : t.rows) {
      fwrite(&r.first, 8, 1, f);
      int64_t st = 0;
      auto it = t.steps.find(r.first);
      if (it != t.steps.end()) st = it->second;
      fwrite(&st, 8, 1, f);
      fwrite(r.second.data(), 4, rl, f);
    }
    // spilled rows belong to the snapshot too (the reference saves the
    // ssd-resident part of the table the same way)
    std::vector<float> vals(rl);
    for (auto& so : t.spill_off) {
      uint64_t key;
      int64_t st;
      if (!t.read_spilled(so.second, &key, &st, vals.data())) {
        fclose(f);
        remove(tmp.c_str());
        return false;
      }
      fwrite(&key, 8, 1, f);
      fwrite(&st, 8, 1, f);
      fwrite(vals.data(), 4, rl, f);
    }
  }
  uint32_t ngr = ps->graph.size();
  fwrite(&ngr, 4, 1, f);
  for (auto& kv : ps->graph) {
    GraphTable& t = kv.second;
    std::lock_guard<std::mutex> lk(t.mu);
    uint32_t id = kv.first, fdim = t.feat_dim;
    uint64_t nn = t.order.size();
    fwrite(&id, 4, 1, f);
    fwrite(&fdim, 4, 1, f);
    fwrite(&nn, 8, 1, f);
    for (uint64_t oi = 0; oi < nn; ++oi) {  // insertion order preserved
      uint64_t nid = t.order[oi];
      GraphNode& nd = t.nodes[nid];
      uint32_t deg = nd.nbr.size();
      fwrite(&nid, 8, 1, f);
      fwrite(&deg, 4, 1, f);
      fwrite(nd.nbr.data(), 8, deg, f);
      fwrite(nd.w.data(), 4, deg, f);
      fwrite(nd.feat.data(), 4, fdim, f);
    }
  }
  bool ok = ferror(f) == 0;
  ok = (fflush(f) == 0) && ok;
  ok = (fclose(f) == 0) && ok;
  if (ok) ok = rename(tmp.c_str(), path.c_str()) == 0;
  if (!ok) remove(tmp.c_str());
  return ok;
}

bool load_tables(PsServer* ps, const std::string& path) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  bool ok = true;  // any short read marks the load failed (partial state
                   // must not be reported as success)
  uint32_t nd = 0, nsp = 0;
  if (fread(&nd, 4, 1, f) != 1 || fread(&nsp, 4, 1, f) != 1) {
    fclose(f);
    return false;
  }
  for (uint32_t i = 0; i < nd; ++i) {
    uint32_t id, n, has_mv;
    int64_t step;
    if (fread(&id, 4, 1, f) != 1 || fread(&n, 4, 1, f) != 1 ||
        fread(&has_mv, 4, 1, f) != 1 || fread(&step, 8, 1, f) != 1) {
      ok = false;
      break;
    }
    DenseTable& t = ps->dense[id];
    std::lock_guard<std::mutex> lk(t.mu);
    t.param.resize(n);
    t.t = step;
    t.initialized = true;
    if (fread(t.param.data(), 4, n, f) != n) { ok = false; break; }
    if (has_mv) {
      t.m.resize(n);
      t.v.resize(n);
      if (fread(t.m.data(), 4, n, f) != n) { ok = false; break; }
      if (fread(t.v.data(), 4, n, f) != n) { ok = false; break; }
    }
  }
  for (uint32_t i = 0; i < nsp; ++i) {
    uint32_t id, rl;
    uint64_t rows;
    if (fread(&id, 4, 1, f) != 1 || fread(&rows, 8, 1, f) != 1 ||
        fread(&rl, 4, 1, f) != 1) {
      ok = false;
      break;
    }
    SparseTable& t = ps->sparse[id];
    std::lock_guard<std::mutex> lk(t.mu);
    t.rows.clear();
    t.steps.clear();
    t.spill_off.clear();
    t.free_slots.clear();
    t.spill_slots = 0;
    t.last_use.clear();
    for (uint64_t r = 0; r < rows; ++r) {
      uint64_t key;
      int64_t st;
      if (fread(&key, 8, 1, f) != 1 || fread(&st, 8, 1, f) != 1) {
        ok = false;
        break;
      }
      std::vector<float> vals(rl);
      if (fread(vals.data(), 4, rl, f) != rl) { ok = false; break; }
      t.rows.emplace(key, std::move(vals));
      if (st) t.steps[key] = st;
      t.maybe_evict();  // re-enforce the RAM budget while loading
    }
  }
  uint32_t ngr = 0;
  if (ok && fread(&ngr, 4, 1, f) == 1) {  // absent in pre-graph snapshots
    for (uint32_t i = 0; i < ngr && ok; ++i) {
      uint32_t id, fdim;
      uint64_t nn;
      if (fread(&id, 4, 1, f) != 1 || fread(&fdim, 4, 1, f) != 1 ||
          fread(&nn, 8, 1, f) != 1) {
        ok = false;
        break;
      }
      GraphTable& t = ps->graph[id];
      std::lock_guard<std::mutex> lk(t.mu);
      t.feat_dim = fdim;
      t.nodes.clear();
      t.order.clear();
      for (uint64_t r = 0; r < nn; ++r) {
        uint64_t nid;
        uint32_t deg;
        if (fread(&nid, 8, 1, f) != 1 || fread(&deg, 4, 1, f) != 1) {
          ok = false;
          break;
        }
        GraphNode& nd = t.node(nid);
        nd.nbr.resize(deg);
        nd.w.resize(deg);
        if (deg && (fread(nd.nbr.data(), 8, deg, f) != deg ||
                    fread(nd.w.data(), 4, deg, f) != deg)) {
          ok = false;
          break;
        }
        if (fdim && fread(nd.feat.data(), 4, fdim, f) != fdim) {
          ok = false;
          break;
        }
      }
    }
  }
  fclose(f);
  return ok;
}

void handle_conn(PsServer* ps, int fd, size_t conn_idx) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  std::vector<char> body;
  std::vector<float> out;
  while (ps->running.load()) {
    uint32_t blen;
    if (!read_all(fd, &blen, 4)) break;
    if (blen < 17 || blen > kMaxFrame) break;  // malformed length: drop
    uint32_t magic;
    if (!read_all(fd, &magic, 4)) break;
    if (magic != kMagic) break;  // wrong protocol/version: drop connection
    body.resize(blen - 4);  // rest of the body, now known to be ours
    if (!read_all(fd, body.data(), blen - 4)) break;
    uint8_t op = (uint8_t)body[0];
    uint32_t table;
    uint64_t n;
    memcpy(&table, body.data() + 1, 4);
    memcpy(&n, body.data() + 5, 8);
    const char* payload = body.data() + 13;
    size_t psize = blen - 17;

    // Traced request: strip the flag + 16-byte trace-context prefix
    // BEFORE any other payload interpretation, so every op family
    // (pushes with request ids included) composes with tracing. A
    // flagged frame too short for the prefix is malformed: drop.
    bool has_trace = false;
    uint64_t trace_id = 0, parent_span = 0;
    if (op & kTraceFlag) {
      if (psize < 16) break;
      memcpy(&trace_id, payload, 8);
      memcpy(&parent_span, payload + 8, 8);
      payload += 16;
      psize -= 16;
      op = (uint8_t)(op & ~kTraceFlag);
      has_trace = true;
    }

    // Request-id'd pushes: consume the id prefix and fold onto the
    // legacy opcode so validation/handling below is shared; the dedup
    // decision is taken after validation (a malformed duplicate frame
    // must still drop the connection, not pollute the seen-set).
    bool has_req_id = false;
    uint64_t req_id = 0;
    if (op == kPushDenseGradId || op == kPushDenseDeltaId ||
        op == kPushSparseGradId || op == kPushSparseDeltaId) {
      if (psize < 8) break;  // malformed: no room for the id
      memcpy(&req_id, payload, 8);
      payload += 8;
      psize -= 8;
      has_req_id = true;
      switch (op) {
        case kPushDenseGradId: op = kPushDenseGrad; break;
        case kPushDenseDeltaId: op = kPushDenseDelta; break;
        case kPushSparseGradId: op = kPushSparseGrad; break;
        default: op = kPushSparseDelta; break;
      }
    }

    // Validate sparse payload sizes against the header count before any
    // table access: a truncated/corrupt frame must not cause out-of-bounds
    // reads (keys are n*8 bytes; pushes carry n*dim*4 grad bytes after).
    if (op == kPullSparse || op == kPushSparseGrad ||
        op == kPushSparseDelta) {
      SparseTable* tp = find_sparse(ps, table);
      uint64_t dim = tp ? (uint64_t)tp->dim : 0;
      bool bad = n > psize / 8;
      if (!bad && op != kPullSparse && dim > 0)
        bad = n > (psize - n * 8) / (dim * 4);
      if (bad) break;  // drop the connection
    }

    auto op_t0 = std::chrono::steady_clock::now();
    int64_t trace_t0 = has_trace ? pt_prof_now_ns() : 0;
    if (has_req_id) {
      int st_req = check_request(ps, req_id);
      if (st_req != kReqNew) {
        // duplicate: ack ok only for a COMPLETED apply (the wait inside
        // check_request makes ok imply visibility); a rejected original
        // or a wait timeout reports failure instead
        uint32_t ok = st_req == kReqDupDone ? 1 : 0;
        send_resp(fd, &ok, 4);
        if (has_trace)  // the dedup-acked retry is part of the trace too
          record_trace_span(ps, trace_id, parent_span, table, op, true,
                            trace_t0);
        std::lock_guard<std::mutex> slk(ps->stats_mu);
        auto& st = ps->op_stats[((uint64_t)table << 8) | op];
        st.calls += 1;
        continue;
      }
    }
    if (op == kStop) {
      uint32_t ok = 1;
      send_resp(fd, &ok, 4);
      ps->running.store(false);
      // connect to self to unblock accept()
      int s = socket(AF_INET, SOCK_STREAM, 0);
      sockaddr_in a{};
      a.sin_family = AF_INET;
      a.sin_port = htons((uint16_t)ps->port);
      a.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
      connect(s, (sockaddr*)&a, sizeof(a));
      close(s);
      break;
    }

    switch (op) {
      case kPullDense:
      case kPullDenseInit: {
        DenseTable* tp = find_dense(ps, table);
        if (!tp) { send_resp(fd, nullptr, 0); break; }
        DenseTable& t = *tp;
        std::lock_guard<std::mutex> lk(t.mu);
        if (op == kPullDenseInit && !t.initialized) {
          t.param.assign((const float*)payload,
                         (const float*)payload + psize / 4);
          t.initialized = true;
        }
        t.ensure(t.param.size());
        send_resp(fd, t.param.data(), t.param.size() * 4);
        break;
      }
      case kPushDenseGrad:
      case kPushDenseDelta: {
        DenseTable* tp = find_dense(ps, table);
        if (!tp) {
          if (has_req_id) finish_request(ps, req_id, false);
          uint32_t ok = 0;
          send_resp(fd, &ok, 4);
          break;
        }
        DenseTable& t = *tp;
        std::lock_guard<std::mutex> lk(t.mu);
        size_t cnt = psize / 4;
        uint32_t ok = 1;
        if (op == kPushDenseDelta) {
          if (!t.ensure(cnt)) {
            ok = 0;  // size mismatch on a live table: reject, don't zero
          } else {
            const float* d = (const float*)payload;
            for (size_t i = 0; i < cnt; ++i) t.param[i] += d[i];
          }
        } else if (!t.apply_grad((const float*)payload, cnt)) {
          ok = 0;
        }
        if (has_req_id) finish_request(ps, req_id, ok != 0);
        send_resp(fd, &ok, 4);
        break;
      }
      case kPullSparse: {
        SparseTable* tp = find_sparse(ps, table);
        if (!tp) { uint32_t ok = 0; send_resp(fd, &ok, 4); break; }
        SparseTable& t = *tp;
        std::lock_guard<std::mutex> lk(t.mu);
        const uint64_t* keys = (const uint64_t*)payload;
        out.resize(n * t.dim);
        for (uint64_t i = 0; i < n; ++i) {
          std::vector<float>& r = t.row(keys[i]);
          memcpy(out.data() + i * t.dim, r.data(), t.dim * 4);
        }
        send_resp(fd, out.data(), out.size() * 4);
        break;
      }
      case kPushSparseGrad: {
        SparseTable* tp = find_sparse(ps, table);
        if (!tp) {
          if (has_req_id) finish_request(ps, req_id, false);
          uint32_t ok = 0;
          send_resp(fd, &ok, 4);
          break;
        }
        SparseTable& t = *tp;
        std::lock_guard<std::mutex> lk(t.mu);
        const uint64_t* keys = (const uint64_t*)payload;
        const float* g = (const float*)(payload + n * 8);
        for (uint64_t i = 0; i < n; ++i)
          t.apply_grad(keys[i], g + i * t.dim);
        uint32_t ok = 1;
        if (has_req_id) finish_request(ps, req_id, true);
        send_resp(fd, &ok, 4);
        break;
      }
      case kPushSparseDelta: {
        SparseTable* tp = find_sparse(ps, table);
        if (!tp) {
          if (has_req_id) finish_request(ps, req_id, false);
          uint32_t ok = 0;
          send_resp(fd, &ok, 4);
          break;
        }
        SparseTable& t = *tp;
        std::lock_guard<std::mutex> lk(t.mu);
        const uint64_t* keys = (const uint64_t*)payload;
        const float* d = (const float*)(payload + n * 8);
        for (uint64_t i = 0; i < n; ++i) {
          std::vector<float>& r = t.row(keys[i]);
          for (int j = 0; j < t.dim; ++j) r[j] += d[i * t.dim + j];
        }
        uint32_t ok = 1;
        if (has_req_id) finish_request(ps, req_id, true);
        send_resp(fd, &ok, 4);
        break;
      }
      case kBarrier: {
        Barrier& b = ps->barrier;
        std::unique_lock<std::mutex> lk(b.mu);
        int64_t gen = b.generation;
        if (++b.arrived >= (int)n) {
          b.arrived = 0;
          ++b.generation;
          b.cv.notify_all();
        } else {
          b.cv.wait(lk, [&] { return b.generation != gen || !ps->running; });
        }
        uint32_t ok = 1;
        send_resp(fd, &ok, 4);
        break;
      }
      case kSave: {
        uint32_t ok = save_tables(ps, std::string(payload, psize)) ? 1 : 0;
        send_resp(fd, &ok, 4);
        break;
      }
      case kLoad: {
        uint32_t ok = load_tables(ps, std::string(payload, psize)) ? 1 : 0;
        send_resp(fd, &ok, 4);
        break;
      }
      case kGraphAddNodes: {
        GraphTable* tp = find_graph(ps, table);
        uint32_t ok = 0;
        // division-form bounds checks throughout the graph ops: n is
        // client-controlled and n*rowbytes could wrap (cf. sparse ops)
        if (tp && n <= psize / (8 + 4ull * tp->feat_dim)) {
          GraphTable& t = *tp;
          std::lock_guard<std::mutex> lk(t.mu);
          const uint64_t* ids = (const uint64_t*)payload;
          const float* feats = (const float*)(payload + n * 8);
          for (uint64_t i = 0; i < n; ++i) {
            GraphNode& nd = t.node(ids[i]);
            memcpy(nd.feat.data(), feats + i * t.feat_dim,
                   t.feat_dim * 4);
          }
          ok = 1;
        }
        send_resp(fd, &ok, 4);
        break;
      }
      case kGraphAddEdges: {
        GraphTable* tp = find_graph(ps, table);
        uint32_t ok = 0;
        if (tp && n <= psize / 20) {  // src u64 + dst u64 + w f32
          GraphTable& t = *tp;
          std::lock_guard<std::mutex> lk(t.mu);
          const uint64_t* src = (const uint64_t*)payload;
          const uint64_t* dst = (const uint64_t*)(payload + n * 8);
          const float* w = (const float*)(payload + n * 16);
          for (uint64_t i = 0; i < n; ++i) {
            GraphNode& nd = t.node(src[i]);
            nd.nbr.push_back(dst[i]);
            nd.w.push_back(w[i]);
          }
          ok = 1;
        }
        send_resp(fd, &ok, 4);
        break;
      }
      case kGraphSampleNeighbors: {
        GraphTable* tp = find_graph(ps, table);
        if (!tp || psize < 12 || n > (psize - 12) / 8) {
          send_resp(fd, nullptr, 0);
          break;
        }
        GraphTable& t = *tp;
        std::lock_guard<std::mutex> lk(t.mu);
        const uint64_t* ids = (const uint64_t*)payload;
        uint32_t k;
        uint64_t seed;
        memcpy(&k, payload + n * 8, 4);
        memcpy(&seed, payload + n * 8 + 4, 8);
        // reply: per id, u32 cnt | cnt * (u64 nbr + f32 weight)
        std::vector<char> resp;
        std::vector<uint32_t> idx;
        for (uint64_t i = 0; i < n; ++i) {
          auto it = t.nodes.find(ids[i]);
          uint32_t deg = it == t.nodes.end()
                             ? 0 : (uint32_t)it->second.nbr.size();
          uint32_t cnt = deg < k ? deg : k;
          size_t at = resp.size();
          resp.resize(at + 4 + cnt * 12ull);
          memcpy(resp.data() + at, &cnt, 4);
          if (!cnt) continue;
          GraphNode& nd = it->second;
          // partial Fisher–Yates over index array, deterministic per
          // (seed, node) — the python mirror in tests reproduces this
          idx.resize(deg);
          for (uint32_t j = 0; j < deg; ++j) idx[j] = j;
          SampleRng rng(mix64(seed ^ mix64(ids[i])));
          char* out_p = resp.data() + at + 4;
          for (uint32_t j = 0; j < cnt; ++j) {
            uint32_t pick = j + (uint32_t)(rng.next() % (deg - j));
            uint32_t tmp = idx[j];
            idx[j] = idx[pick];
            idx[pick] = tmp;
            memcpy(out_p + j * 12, &nd.nbr[idx[j]], 8);
            memcpy(out_p + j * 12 + 8, &nd.w[idx[j]], 4);
          }
        }
        send_resp(fd, resp.data(), (uint32_t)resp.size());
        break;
      }
      case kGraphPullList: {
        GraphTable* tp = find_graph(ps, table);
        if (!tp || psize < 16) { send_resp(fd, nullptr, 0); break; }
        GraphTable& t = *tp;
        std::lock_guard<std::mutex> lk(t.mu);
        uint64_t start, count;
        memcpy(&start, payload, 8);
        memcpy(&count, payload + 8, 8);
        if (start > t.order.size()) start = t.order.size();
        uint64_t avail = t.order.size() - start;  // wrap-safe clamp
        if (count > avail) count = avail;
        send_resp(fd, t.order.data() + start, (uint32_t)(count * 8));
        break;
      }
      case kGraphNodeFeat: {
        GraphTable* tp = find_graph(ps, table);
        if (!tp || n > psize / 8) { send_resp(fd, nullptr, 0); break; }
        GraphTable& t = *tp;
        std::lock_guard<std::mutex> lk(t.mu);
        const uint64_t* ids = (const uint64_t*)payload;
        out.assign(n * t.feat_dim, 0.0f);
        for (uint64_t i = 0; i < n; ++i) {
          auto it = t.nodes.find(ids[i]);
          if (it != t.nodes.end())
            memcpy(out.data() + i * t.feat_dim, it->second.feat.data(),
                   t.feat_dim * 4);
        }
        send_resp(fd, out.data(), (uint32_t)(out.size() * 4));
        break;
      }
      case kGraphRandomNodes: {
        GraphTable* tp = find_graph(ps, table);
        if (!tp || psize < 12) { send_resp(fd, nullptr, 0); break; }
        GraphTable& t = *tp;
        std::lock_guard<std::mutex> lk(t.mu);
        uint32_t k;
        uint64_t seed;
        memcpy(&k, payload, 4);
        memcpy(&seed, payload + 4, 8);
        uint32_t total = (uint32_t)t.order.size();
        uint32_t cnt = k < total ? k : total;
        // sparse Fisher–Yates: O(k) displaced-slot map instead of
        // materializing an O(total) index array per request
        std::unordered_map<uint32_t, uint32_t> moved;
        SampleRng rng(mix64(seed));
        std::vector<uint64_t> picked(cnt);
        for (uint32_t j = 0; j < cnt; ++j) {
          uint32_t pick = j + (uint32_t)(rng.next() % (total - j));
          auto itj = moved.find(j);
          auto itp = moved.find(pick);
          uint32_t vj = itj == moved.end() ? j : itj->second;
          uint32_t vp = itp == moved.end() ? pick : itp->second;
          moved[j] = vp;
          moved[pick] = vj;
          picked[j] = t.order[vp];
        }
        send_resp(fd, picked.data(), cnt * 8);
        break;
      }
      case kGraphSize: {
        GraphTable* tp = find_graph(ps, table);
        uint64_t sz = 0;
        if (tp) {
          std::lock_guard<std::mutex> lk(tp->mu);
          sz = tp->nodes.size();
        }
        send_resp(fd, &sz, 8);
        break;
      }
      case kSparseSize: {
        SparseTable* tp = find_sparse(ps, table);
        if (!tp) { uint64_t z = 0; send_resp(fd, &z, 8); break; }
        SparseTable& t = *tp;
        std::lock_guard<std::mutex> lk(t.mu);
        uint64_t sz = t.rows.size() + t.spill_off.size();
        send_resp(fd, &sz, 8);
        break;
      }
      case kPullSpans: {
        // Serialize the ring for a remote client; `n != 0` drains. The
        // ring is swapped out BEFORE the send, so a lost response loses
        // those spans — they are telemetry, not state, and the client's
        // retry simply returns whatever accumulated since.
        std::deque<TraceSpan> spans;
        {
          std::lock_guard<std::mutex> tlk(ps->trace_mu);
          if (n != 0)
            spans.swap(ps->trace_ring);
          else
            spans = ps->trace_ring;
        }
        std::string s = "[";
        bool first = true;
        for (auto& sp : spans) {
          append_span_json(s, sp, first);
          first = false;
        }
        s += "]";
        send_resp(fd, s.data(), (uint32_t)s.size());
        break;
      }
      case kSparseSpillInfo: {
        SparseTable* tp = find_sparse(ps, table);
        uint64_t info[3] = {0, 0, 0};
        if (tp) {
          std::lock_guard<std::mutex> lk(tp->mu);
          info[0] = tp->rows.size();
          info[1] = tp->spill_off.size();
          info[2] = tp->spill_failures;
        }
        send_resp(fd, info, 24);
        break;
      }
      default: {
        uint32_t ok = 0;
        send_resp(fd, &ok, 4);
        break;
      }
    }
    uint64_t op_ns = (uint64_t)std::chrono::duration_cast<
        std::chrono::nanoseconds>(std::chrono::steady_clock::now() - op_t0)
        .count();
    if (has_trace)
      record_trace_span(ps, trace_id, parent_span, table, op, false,
                        trace_t0);
    {
      std::lock_guard<std::mutex> slk(ps->stats_mu);
      auto& st = ps->op_stats[((uint64_t)table << 8) | op];
      st.calls += 1;
      st.ns += op_ns;
    }
  }
  // Close under conns_mu and mark the slot so pt_ps_stop never calls
  // shutdown() on a recycled fd number.
  std::lock_guard<std::mutex> lk(ps->conns_mu);
  close(fd);
  if (conn_idx < ps->conn_fds.size()) ps->conn_fds[conn_idx] = -1;
}

void accept_loop(PsServer* ps) {
  while (ps->running.load()) {
    sockaddr_in cli{};
    socklen_t len = sizeof(cli);
    int fd = accept(ps->listen_fd, (sockaddr*)&cli, &len);
    if (fd < 0) continue;
    if (!ps->running.load()) {
      close(fd);
      break;
    }
    std::lock_guard<std::mutex> lk(ps->conns_mu);
    // Reap finished handlers first: client reconnect-with-backoff makes
    // connection churn routine, and an unjoined thread pins its stack.
    // Joined slots stay as cheap tombstones so conn_idx stays stable.
    for (size_t i = 0; i < ps->conns.size(); ++i)
      if (ps->conn_fds[i] == -1 && ps->conns[i].joinable())
        ps->conns[i].join();
    ps->conn_fds.push_back(fd);
    ps->conns.emplace_back(handle_conn, ps, fd, ps->conn_fds.size() - 1);
  }
  // wake any barrier waiters so their conns can exit
  {
    std::lock_guard<std::mutex> lk(ps->barrier.mu);
    ps->barrier.cv.notify_all();
  }
}

}  // namespace

PT_API void pt_ps_stop();

PT_API void pt_ps_reset() {
  pt_ps_stop();  // idempotent; joins any leftover threads
  std::lock_guard<std::mutex> lk(g_ps_mu);
  if (g_ps && g_ps->running.load()) return;  // still live: refuse
  delete g_ps;
  g_ps = new PsServer();
}

PT_API void pt_ps_add_dense(uint32_t table, int32_t dim, int32_t opt_kind,
                            float lr, float beta1, float beta2, float eps) {
  std::lock_guard<std::mutex> lk(g_ps_mu);
  if (!g_ps) g_ps = new PsServer();
  DenseTable& t = g_ps->dense[table];
  t.dim = dim;
  t.opt = {opt_kind, lr, beta1, beta2, eps};
}

PT_API void pt_ps_add_sparse(uint32_t table, int32_t dim, int32_t opt_kind,
                             float lr, float beta1, float beta2, float eps,
                             float init_range, uint64_t seed) {
  std::lock_guard<std::mutex> lk(g_ps_mu);
  if (!g_ps) g_ps = new PsServer();
  SparseTable& t = g_ps->sparse[table];
  t.dim = dim;
  t.opt = {opt_kind, lr, beta1, beta2, eps};
  t.init_range = init_range;
  t.seed = seed;
}

// Configure out-of-core spill for a sparse table (reference:
// ssd_sparse_table.cc). Call after pt_ps_add_sparse, before start.
PT_API void pt_ps_sparse_spill(uint32_t table, uint64_t budget_rows,
                               const char* path) {
  std::lock_guard<std::mutex> lk(g_ps_mu);
  if (!g_ps) g_ps = new PsServer();
  SparseTable& t = g_ps->sparse[table];
  t.budget = budget_rows;
  t.spill_path = path ? path : "";
}

PT_API void pt_ps_add_graph(uint32_t table, int32_t feat_dim) {
  std::lock_guard<std::mutex> lk(g_ps_mu);
  if (!g_ps) g_ps = new PsServer();
  g_ps->graph[table].feat_dim = feat_dim;
}

// returns the bound port (pass 0 for an ephemeral port), or -1 on error
PT_API int32_t pt_ps_start(int32_t port) {
  std::lock_guard<std::mutex> lk(g_ps_mu);
  if (!g_ps) g_ps = new PsServer();
  PsServer* ps = g_ps;
  if (ps->running.load()) return ps->port;
  ps->listen_fd = socket(AF_INET, SOCK_STREAM, 0);
  if (ps->listen_fd < 0) return -1;
  int one = 1;
  setsockopt(ps->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons((uint16_t)port);
  if (bind(ps->listen_fd, (sockaddr*)&addr, sizeof(addr)) < 0) {
    close(ps->listen_fd);
    return -1;
  }
  socklen_t alen = sizeof(addr);
  getsockname(ps->listen_fd, (sockaddr*)&addr, &alen);
  ps->port = ntohs(addr.sin_port);
  if (listen(ps->listen_fd, 64) < 0) {
    close(ps->listen_fd);
    return -1;
  }
  ps->running.store(true);
  ps->accept_thread = std::thread(accept_loop, ps);
  return ps->port;
}

PT_API void pt_ps_stop() {
  PsServer* ps;
  {
    std::lock_guard<std::mutex> lk(g_ps_mu);
    ps = g_ps;
  }
  if (!ps || ps->listen_fd < 0) return;
  // Threads must be joined even when a client STOP already cleared
  // `running` (the handler thread cannot join itself); deleting a
  // PsServer with joinable std::threads would std::terminate.
  if (ps->running.exchange(false)) {
    // self-connect to unblock accept()
    int s = socket(AF_INET, SOCK_STREAM, 0);
    sockaddr_in a{};
    a.sin_family = AF_INET;
    a.sin_port = htons((uint16_t)ps->port);
    a.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
    connect(s, (sockaddr*)&a, sizeof(a));
    close(s);
  }
  if (ps->accept_thread.joinable()) ps->accept_thread.join();
  close(ps->listen_fd);
  ps->listen_fd = -1;
  // A handler blocked in read_all() on a still-open client socket would
  // block join() forever; shutdown() every live conn fd first so those
  // reads return 0 and the handlers exit.
  {
    std::lock_guard<std::mutex> lk(ps->conns_mu);
    for (int cfd : ps->conn_fds)
      if (cfd >= 0) shutdown(cfd, SHUT_RDWR);
  }
  {
    std::lock_guard<std::mutex> lk(ps->barrier.mu);
    ps->barrier.cv.notify_all();  // release any barrier waiters
  }
  std::vector<std::thread> conns;
  {
    std::lock_guard<std::mutex> lk(ps->conns_mu);
    conns.swap(ps->conns);  // join without holding conns_mu (handlers
                            // take it to close their fds on exit)
  }
  for (auto& t : conns)
    if (t.joinable()) t.join();
  {
    std::lock_guard<std::mutex> lk(ps->conns_mu);
    ps->conn_fds.clear();
  }
}

PT_API int32_t pt_ps_port() {
  std::lock_guard<std::mutex> lk(g_ps_mu);
  return g_ps ? g_ps->port : -1;
}

// how many duplicate (request-id-deduped) pushes the server acked
// without re-applying — a rising value means clients are riding their
// retry budget over lost responses
PT_API int64_t pt_ps_dup_requests() {
  std::lock_guard<std::mutex> lk(g_ps_mu);
  if (!g_ps) return 0;
  std::lock_guard<std::mutex> slk(g_ps->seen_mu);
  return (int64_t)g_ps->dup_requests;
}

PT_API int32_t pt_ps_running() {
  std::lock_guard<std::mutex> lk(g_ps_mu);
  return g_ps && g_ps->running.load() ? 1 : 0;
}

// Serialize (and, with drain != 0, clear) the service-side trace-span
// ring as a JSON array — u64 ids printed as decimal (Python ints parse
// them losslessly). Same size-probe protocol as pt_ps_stats_json:
// returns bytes written, or the negated required size when `cap` is too
// small (nothing written, nothing drained — a failed probe must not
// lose spans).
PT_API int32_t pt_ps_trace_json(char* out, int32_t cap, int32_t drain) {
  std::lock_guard<std::mutex> lk(g_ps_mu);
  std::string s = "[";
  if (g_ps) {
    std::lock_guard<std::mutex> tlk(g_ps->trace_mu);
    bool first = true;
    for (auto& sp : g_ps->trace_ring) {
      append_span_json(s, sp, first);
      first = false;
    }
    if ((int32_t)s.size() + 2 <= cap && drain) g_ps->trace_ring.clear();
  }
  s += "]";
  if ((int32_t)s.size() + 1 > cap) return -(int32_t)(s.size() + 1);
  memcpy(out, s.c_str(), s.size() + 1);
  return (int32_t)s.size();
}

// Serialize the per-(table, op) latency stats as a JSON array. Returns
// bytes written (NUL excluded); if `cap` is too small returns the
// negated required size (incl. NUL) and writes nothing.
PT_API int32_t pt_ps_stats_json(char* out, int32_t cap) {
  std::lock_guard<std::mutex> lk(g_ps_mu);
  std::string s = "[";
  if (g_ps) {
    std::lock_guard<std::mutex> slk(g_ps->stats_mu);
    bool first = true;
    for (auto& kv : g_ps->op_stats) {
      char buf[128];
      snprintf(buf, sizeof(buf),
               "%s{\"table\":%u,\"op\":%u,\"calls\":%llu,\"ns\":%llu}",
               first ? "" : ",", (uint32_t)(kv.first >> 8),
               (uint32_t)(kv.first & 0xff),
               (unsigned long long)kv.second.calls,
               (unsigned long long)kv.second.ns);
      s += buf;
      first = false;
    }
  }
  s += "]";
  if ((int32_t)s.size() + 1 > cap) return -(int32_t)(s.size() + 1);
  memcpy(out, s.c_str(), s.size() + 1);
  return (int32_t)s.size();
}
