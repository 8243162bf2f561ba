// Memory sparse table — the host-resident embedding store of the PS
// subsystem. TPU-native counterpart of the reference's C++
// MemorySparseTable (paddle/fluid/distributed/ps/table/memory_sparse_table.cc)
// + SparseSgdRule accessors (ps/table/sparse_sgd_rule.cc): sharded hash maps
// with striped locks, lazily-initialized rows, and fused pull/push kernels so
// the hot path (CTR-scale embedding lookup/update) never touches Python.
//
// Exposed as a C ABI for ctypes binding (no pybind11 in this image).
//
// SSD tier (reference: ps/table/ssd_sparse_table.cc over rocksdb): a
// log-structured spill file + in-memory offset index. pt_sparse_table_spill
// evicts the coldest rows (oldest push version) past a row budget to disk;
// pull/push transparently fault disk-resident rows back into memory. The
// index costs ~16 bytes/key vs (2*dim*4 + overhead) for a resident row, so
// CTR-scale vocabularies fit host RAM + disk.
#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <mutex>
#include <shared_mutex>
#include <random>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include <unistd.h>  // pread: thread-safe positioned reads of the spill log

namespace {

struct Row {
  std::vector<float> emb;    // embedding weights [dim]
  std::vector<float> state;  // optimizer slot (adagrad G / momentum) [dim]
  // Bumped on EVERY mutation (push, add, assign, add_show, load) — not just
  // push. The two-pass spill's re-verification relies on this: a mutator
  // that skips the bump lets spill publish its pre-mutation snapshot and
  // erase the memory copy, silently undoing the mutation. Also the
  // geo-sync watermark.
  uint64_t version = 0;
  float show = 0.f;          // CTR accessor statistics
  float click = 0.f;
};

struct Shard {
  std::unordered_map<uint64_t, Row> map;
  std::mutex mu;
};

// Log-structured disk tier: records appended as
// [key u64][version u64][show f32][click f32][emb f32*dim][state f32*dim];
// the in-memory index maps key -> latest record offset (older records
// become garbage; pt_sparse_table_ssd_compact rewrites the log).
struct DiskTier {
  FILE* f = nullptr;
  std::string path;
  std::unordered_map<uint64_t, uint64_t> index;
  // shared: concurrent pread faults (the CTR pull-storm hot path);
  // exclusive: appends, index mutation, compaction's file swap
  std::shared_mutex mu;

  ~DiskTier() {
    if (f) std::fclose(f);
  }
};

enum class Optimizer : int { kSGD = 0, kAdagrad = 1, kMomentum = 2 };

struct Table {
  int dim;
  int shard_bits;
  Optimizer opt;
  float init_range;
  float lr_default;
  float momentum_or_eps;  // momentum coeff / adagrad epsilon
  std::vector<Shard> shards;
  std::atomic<uint64_t> global_version{0};
  uint64_t seed;
  std::unique_ptr<DiskTier> ssd;  // optional overflow tier
  // serializes the cross-tier maintenance ops (spill/compact/save/shrink):
  // their mem-key snapshots are only consistent if no concurrent spill can
  // move rows between tiers mid-operation. Never held while a shard or
  // tier mutex is already held (maint -> shard -> tier lock order).
  std::mutex maint_mu;

  Table(int d, int bits, int opt_kind, float init, float lr, float aux,
        uint64_t seed_)
      : dim(d),
        shard_bits(bits),
        opt(static_cast<Optimizer>(opt_kind)),
        init_range(init),
        lr_default(lr),
        momentum_or_eps(aux),
        shards(size_t(1) << bits),
        seed(seed_) {}

  inline Shard& shard_of(uint64_t key) {
    if (shard_bits == 0) return shards[0];
    // multiplicative hash → top bits pick the shard
    uint64_t h = key * 0x9E3779B97F4A7C15ull;
    return shards[h >> (64 - shard_bits)];
  }

  void init_row(Row& row, uint64_t key) {
    row.emb.resize(dim);
    row.state.assign(dim, 0.f);
    // deterministic in (key, table seed) only — identical across ranks and
    // restarts regardless of materialization order
    uint64_t h = (key ^ seed) * 0x9E3779B97F4A7C15ull;
    h ^= h >> 29;
    std::mt19937 gen(static_cast<uint32_t>(h ^ (h >> 32)));
    std::uniform_real_distribution<float> dist(-init_range, init_range);
    for (int i = 0; i < dim; ++i) row.emb[i] = dist(gen);
  }

  // Lock order everywhere: shard.mu THEN ssd->mu (never the reverse).

  // record header: [key u64][version u64][show f32][click f32]
  static constexpr size_t kHeadBytes = 8 + 8 + 4 + 4;
  size_t rec_bytes() const { return kHeadBytes + 2 * sizeof(float) * dim; }

  // Append one record WITHOUT flushing or publishing (caller holds
  // ssd->mu exclusive). The offset is only safe to publish in the index
  // AFTER an fflush — pread readers bypass the stdio buffer. On a short
  // write the log tail is garbage but unreferenced.
  bool ssd_append_raw_locked(uint64_t key, const Row& row, uint64_t* off) {
    if (!ssd->f) return false;
    std::fseek(ssd->f, 0, SEEK_END);
    *off = static_cast<uint64_t>(std::ftell(ssd->f));
    size_t ok = 0;
    ok += std::fwrite(&key, 8, 1, ssd->f);
    ok += std::fwrite(&row.version, 8, 1, ssd->f);
    ok += std::fwrite(&row.show, 4, 1, ssd->f);
    ok += std::fwrite(&row.click, 4, 1, ssd->f);
    ok += (std::fwrite(row.emb.data(), sizeof(float), dim, ssd->f) ==
           static_cast<size_t>(dim));
    ok += (std::fwrite(row.state.data(), sizeof(float), dim, ssd->f) ==
           static_cast<size_t>(dim));
    return ok == 6;
  }

  bool ssd_append_locked(uint64_t key, const Row& row) {
    // single-record append + flush + publish (callers that batch use
    // ssd_append_raw_locked and flush once)
    uint64_t off;
    if (!ssd_append_raw_locked(key, row, &off)) return false;
    if (std::fflush(ssd->f) != 0) return false;
    ssd->index[key] = off;
    return true;
  }

  bool ssd_read_locked(uint64_t key, Row& out) {
    // caller holds ssd->mu EXCLUSIVE (maintenance paths: shrink/save/
    // compact iterate the index and may interleave appends)
    if (!ssd->f) return false;
    auto it = ssd->index.find(key);
    if (it == ssd->index.end()) return false;
    std::fflush(ssd->f);
    std::fseek(ssd->f, static_cast<long>(it->second), SEEK_SET);
    uint64_t k2 = 0;
    out.emb.resize(dim);
    out.state.resize(dim);
    if (std::fread(&k2, 8, 1, ssd->f) != 1 || k2 != key ||
        std::fread(&out.version, 8, 1, ssd->f) != 1 ||
        std::fread(&out.show, 4, 1, ssd->f) != 1 ||
        std::fread(&out.click, 4, 1, ssd->f) != 1 ||
        std::fread(out.emb.data(), sizeof(float), dim, ssd->f) !=
            static_cast<size_t>(dim) ||
        std::fread(out.state.data(), sizeof(float), dim, ssd->f) !=
            static_cast<size_t>(dim)) {
      return false;
    }
    return true;
  }

  bool ssd_read_shared(uint64_t key, Row& out, uint64_t* off_out,
                       bool with_payload = true) {
    // Concurrent fault path: index lookup + pread under a SHARED lock.
    // pread needs no seek (no FILE* position races) and the exclusive
    // lock taken by compaction's file swap keeps the fd valid for the
    // read's duration. Appends fflush before publishing their index
    // entry, so a published offset always has its bytes in the kernel.
    if (!ssd) return false;
    std::shared_lock<std::shared_mutex> g(ssd->mu);
    if (!ssd->f) return false;
    auto it = ssd->index.find(key);
    if (it == ssd->index.end()) return false;
    *off_out = it->second;
    const int fd = ::fileno(ssd->f);
    const off_t base = static_cast<off_t>(it->second);
    // header to the stack, payloads straight into the row's buffers — no
    // per-fault heap allocation on the pull-storm hot path
    char head[kHeadBytes];
    if (::pread(fd, head, sizeof(head), base) !=
        static_cast<ssize_t>(sizeof(head)))
      return false;
    uint64_t k2;
    std::memcpy(&k2, head, 8);
    if (k2 != key) return false;
    std::memcpy(&out.version, head + 8, 8);
    std::memcpy(&out.show, head + 16, 4);
    std::memcpy(&out.click, head + 20, 4);
    if (!with_payload) return true;  // caller will overwrite emb/state
    out.emb.resize(dim);
    out.state.resize(dim);
    const ssize_t payload = static_cast<ssize_t>(sizeof(float)) * dim;
    if (::pread(fd, out.emb.data(), payload, base + kHeadBytes) != payload ||
        ::pread(fd, out.state.data(), payload,
                base + kHeadBytes + payload) != payload)
      return false;
    return true;
  }

  // Fault a disk-resident row into `s.map` (caller holds s.mu). Returns the
  // iterator, or map.end() when the key lives on neither tier. The disk
  // record is dropped from the index: leaving it would let a later shrink
  // of the memory copy resurrect the stale pre-spill row.
  // with_payload=false skips the emb/state preads (header stats only) for
  // callers about to overwrite both, e.g. checkpoint load; the rare
  // moved-offset fallback below still reads fully, which is harmless.
  std::unordered_map<uint64_t, Row>::iterator fault_in(
      Shard& s, uint64_t key, bool with_payload = true) {
    if (!ssd) return s.map.end();
    Row row;
    uint64_t off;
    // read under the SHARED lock (concurrent with other shards' faults).
    // spill/assign writers of THIS key take s.mu first (which we hold),
    // but shrink's disk phase rewrites/drops records under ssd->mu alone
    // — so before consuming the copy, re-validate the offset under the
    // exclusive lock and re-read (or give up) if it moved.
    if (!ssd_read_shared(key, row, &off, with_payload)) return s.map.end();
    {
      std::lock_guard<std::shared_mutex> g(ssd->mu);
      auto it = ssd->index.find(key);
      if (it == ssd->index.end()) return s.map.end();  // shrink evicted it
      if (it->second != off && !ssd_read_locked(key, row))
        return s.map.end();  // rewritten (decayed stats): take the new copy
      ssd->index.erase(key);
    }
    return s.map.emplace(key, std::move(row)).first;
  }
};

}  // namespace

extern "C" {

void* pt_sparse_table_create(int dim, int shard_bits, int opt_kind,
                             float init_range, float lr, float aux,
                             uint64_t seed) {
  if (shard_bits < 0 || shard_bits > 16 || dim <= 0) return nullptr;
  return new Table(dim, shard_bits, opt_kind, init_range, lr, aux, seed);
}

void pt_sparse_table_destroy(void* t) { delete static_cast<Table*>(t); }

int pt_sparse_table_dim(void* t) { return static_cast<Table*>(t)->dim; }

static std::unordered_set<uint64_t> mem_key_snapshot(Table* tab) {
  std::unordered_set<uint64_t> mem;
  for (auto& s : tab->shards) {
    std::lock_guard<std::mutex> g(s.mu);
    for (auto& kv : s.map) mem.insert(kv.first);
  }
  return mem;
}

uint64_t pt_sparse_table_size(void* t) {
  auto* tab = static_cast<Table*>(t);
  if (!tab->ssd) {  // common case: cheap per-shard sum, no key walk
    uint64_t n = 0;
    for (auto& s : tab->shards) {
      std::lock_guard<std::mutex> g(s.mu);
      n += s.map.size();
    }
    return n;
  }
  // union of the memory tier and disk-only keys (an assigned row may exist
  // on both tiers; the memory copy is authoritative)
  auto mem = mem_key_snapshot(tab);
  uint64_t n = mem.size();
  std::shared_lock<std::shared_mutex> g(tab->ssd->mu);
  for (auto& kv : tab->ssd->index)
    if (!mem.count(kv.first)) ++n;
  return n;
}

uint64_t pt_sparse_table_mem_rows(void* t) {
  auto* tab = static_cast<Table*>(t);
  uint64_t n = 0;
  for (auto& s : tab->shards) {
    std::lock_guard<std::mutex> g(s.mu);
    n += s.map.size();
  }
  return n;
}

// Pull rows for n keys into out[n * dim]; missing keys are initialized
// (create_if_missing != 0) or zero-filled.
void pt_sparse_table_pull(void* t, const uint64_t* keys, int64_t n,
                          float* out, int create_if_missing) {
  auto* tab = static_cast<Table*>(t);
  const int dim = tab->dim;
  for (int64_t i = 0; i < n; ++i) {
    Shard& s = tab->shard_of(keys[i]);
    std::lock_guard<std::mutex> g(s.mu);
    auto it = s.map.find(keys[i]);
    if (it == s.map.end()) it = tab->fault_in(s, keys[i]);
    if (it == s.map.end()) {
      if (!create_if_missing) {
        std::memset(out + i * dim, 0, sizeof(float) * dim);
        continue;
      }
      it = s.map.emplace(keys[i], Row{}).first;
      tab->init_row(it->second, keys[i]);
    }
    std::memcpy(out + i * dim, it->second.emb.data(), sizeof(float) * dim);
  }
}

// Apply gradients for n keys (duplicate keys fold sequentially — downpour
// semantics). lr<=0 uses the table default.
void pt_sparse_table_push(void* t, const uint64_t* keys, int64_t n,
                          const float* grads, float lr) {
  auto* tab = static_cast<Table*>(t);
  const int dim = tab->dim;
  const float eta = lr > 0.f ? lr : tab->lr_default;
  for (int64_t i = 0; i < n; ++i) {
    Shard& s = tab->shard_of(keys[i]);
    std::lock_guard<std::mutex> g(s.mu);
    auto it = s.map.find(keys[i]);
    if (it == s.map.end()) it = tab->fault_in(s, keys[i]);
    if (it == s.map.end()) {
      it = s.map.emplace(keys[i], Row{}).first;
      tab->init_row(it->second, keys[i]);
    }
    Row& row = it->second;
    const float* gi = grads + i * dim;
    switch (tab->opt) {
      case Optimizer::kSGD:
        for (int d = 0; d < dim; ++d) row.emb[d] -= eta * gi[d];
        break;
      case Optimizer::kAdagrad:
        for (int d = 0; d < dim; ++d) {
          row.state[d] += gi[d] * gi[d];
          row.emb[d] -=
              eta * gi[d] / (std::sqrt(row.state[d]) + tab->momentum_or_eps);
        }
        break;
      case Optimizer::kMomentum:
        for (int d = 0; d < dim; ++d) {
          row.state[d] = tab->momentum_or_eps * row.state[d] + gi[d];
          row.emb[d] -= eta * row.state[d];
        }
        break;
    }
    row.version = ++tab->global_version;
  }
}

// Atomically add deltas to rows (geo-SGD server-side merge,
// geo_recorder/communicator delta semantics): unlike a client-side
// pull+assign, concurrent workers' deltas can never lose updates.
void pt_sparse_table_add(void* t, const uint64_t* keys, int64_t n,
                         const float* deltas) {
  auto* tab = static_cast<Table*>(t);
  const int dim = tab->dim;
  for (int64_t i = 0; i < n; ++i) {
    Shard& s = tab->shard_of(keys[i]);
    std::lock_guard<std::mutex> g(s.mu);
    auto it = s.map.find(keys[i]);
    if (it == s.map.end()) it = tab->fault_in(s, keys[i]);
    if (it == s.map.end()) {
      it = s.map.emplace(keys[i], Row{}).first;
      tab->init_row(it->second, keys[i]);
    }
    Row& row = it->second;
    const float* di = deltas + i * dim;
    for (int d = 0; d < dim; ++d) row.emb[d] += di[d];
    row.version = ++tab->global_version;
  }
}

// Overwrite rows (used by load / broadcast init).
void pt_sparse_table_assign(void* t, const uint64_t* keys, int64_t n,
                            const float* vals) {
  auto* tab = static_cast<Table*>(t);
  const int dim = tab->dim;
  for (int64_t i = 0; i < n; ++i) {
    Shard& s = tab->shard_of(keys[i]);
    std::lock_guard<std::mutex> g(s.mu);
    auto it = s.map.find(keys[i]);
    // fault a spilled row into memory before overwriting so its show/click
    // stats survive the assign exactly like a memory-resident row's do
    // (fault_in also erases the disk record, so no stale copy remains)
    if (it == s.map.end()) it = tab->fault_in(s, keys[i]);
    if (it == s.map.end()) it = s.map.emplace(keys[i], Row{}).first;
    Row& row = it->second;
    if (row.emb.empty()) {
      row.emb.resize(dim);
      row.state.assign(dim, 0.f);
    }
    std::memcpy(row.emb.data(), vals + i * dim, sizeof(float) * dim);
    // bump version on EVERY mutation (not just push): the two-pass
    // spill's re-verification uses it to detect rows touched between its
    // snapshot append and its erase — an assign that didn't bump would
    // be silently undone by the spill publishing the pre-assign record
    row.version = ++tab->global_version;
    if (tab->ssd) {
      // same hazard fault_in guards against: a stale disk record would
      // resurrect the pre-assign row after a memory-tier shrink
      std::lock_guard<std::shared_mutex> g2(tab->ssd->mu);
      tab->ssd->index.erase(keys[i]);
    }
  }
}

// Snapshot keys (both tiers) into out_keys (caller allocates via size()).
int64_t pt_sparse_table_keys(void* t, uint64_t* out_keys, int64_t cap) {
  auto* tab = static_cast<Table*>(t);
  int64_t n = 0;
  std::unordered_set<uint64_t> seen;
  for (auto& s : tab->shards) {
    std::lock_guard<std::mutex> g(s.mu);
    for (auto& kv : s.map) {
      if (n >= cap) return n;
      out_keys[n++] = kv.first;
      if (tab->ssd) seen.insert(kv.first);
    }
  }
  if (tab->ssd) {
    std::shared_lock<std::shared_mutex> g(tab->ssd->mu);
    for (auto& kv : tab->ssd->index) {
      if (seen.count(kv.first)) continue;
      if (n >= cap) return n;
      out_keys[n++] = kv.first;
    }
  }
  return n;
}

// Drop rows whose show-count decays below `threshold` (table shrink).
// Accessor-driven eviction as in the reference MemorySparseTable::shrink:
// ANY row whose decayed show falls under the threshold is evicted, trained
// or not — otherwise CTR tables grow without bound. Disk-resident rows are
// shrunk too (ssd_sparse_table.cc behavior): dropped entries leave the
// index, survivors get their decayed stats re-appended to the log.
int64_t pt_sparse_table_shrink(void* t, float decay, float threshold) {
  auto* tab = static_cast<Table*>(t);
  std::lock_guard<std::mutex> maint(tab->maint_mu);
  int64_t dropped = 0;
  for (auto& s : tab->shards) {
    std::lock_guard<std::mutex> g(s.mu);
    for (auto it = s.map.begin(); it != s.map.end();) {
      it->second.show *= decay;
      if (it->second.show < threshold) {
        it = s.map.erase(it);
        ++dropped;
      } else {
        ++it;
      }
    }
  }
  if (tab->ssd) {
    auto mem = mem_key_snapshot(tab);
    std::lock_guard<std::shared_mutex> g(tab->ssd->mu);
    std::vector<uint64_t> disk_keys;
    for (auto& kv : tab->ssd->index)
      if (!mem.count(kv.first)) disk_keys.push_back(kv.first);
    std::vector<std::pair<uint64_t, uint64_t>> republished;
    for (uint64_t key : disk_keys) {
      Row row;
      if (!tab->ssd_read_locked(key, row)) continue;
      row.show *= decay;
      if (row.show < threshold) {
        tab->ssd->index.erase(key);
        ++dropped;
      } else {
        uint64_t off;
        if (!tab->ssd_append_raw_locked(key, row, &off)) {
          // disk write failure: the old record (un-decayed show) still
          // backs the index; surface the error instead of silently making
          // cold disk rows un-evictable
          return -1;
        }
        republished.emplace_back(key, off);
      }
    }
    if (!republished.empty()) {
      // one flush for the whole batch, THEN publish (pread visibility)
      if (std::fflush(tab->ssd->f) != 0) return -1;
      for (auto& kv : republished) tab->ssd->index[kv.first] = kv.second;
    }
  }
  return dropped;
}

void pt_sparse_table_add_show(void* t, const uint64_t* keys, int64_t n,
                              float amount) {
  auto* tab = static_cast<Table*>(t);
  for (int64_t i = 0; i < n; ++i) {
    Shard& s = tab->shard_of(keys[i]);
    std::lock_guard<std::mutex> g(s.mu);
    auto it = s.map.find(keys[i]);
    // spilled rows fault back in: an impression on a disk-resident row must
    // count, or shrink wrongly evicts genuinely hot rows
    if (it == s.map.end()) it = tab->fault_in(s, keys[i]);
    if (it != s.map.end()) {
      it->second.show += amount;
      it->second.version = ++tab->global_version;  // mutation: see assign
    }
  }
}

// Binary save/load: header (magic, dim, count) then key + emb + state rows.
int pt_sparse_table_save(void* t, const char* path) {
  auto* tab = static_cast<Table*>(t);
  std::lock_guard<std::mutex> maint(tab->maint_mu);
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  const uint64_t magic = 0x50545350u;  // "PTSP"
  uint64_t count = 0;  // patched after the single write pass (no size()
                       // pre-pass: concurrent pushes would desync the header)
  uint64_t dim = static_cast<uint64_t>(tab->dim);
  std::fwrite(&magic, 8, 1, f);
  std::fwrite(&dim, 8, 1, f);
  long count_off = std::ftell(f);
  std::fwrite(&count, 8, 1, f);
  std::unordered_set<uint64_t> mem;
  for (auto& s : tab->shards) {
    std::lock_guard<std::mutex> g(s.mu);
    for (auto& kv : s.map) {
      std::fwrite(&kv.first, 8, 1, f);
      std::fwrite(kv.second.emb.data(), sizeof(float), tab->dim, f);
      std::fwrite(kv.second.state.data(), sizeof(float), tab->dim, f);
      ++count;
      if (tab->ssd) mem.insert(kv.first);
    }
  }
  if (tab->ssd) {
    // disk-only rows belong in the checkpoint too (memory copy wins when
    // a key lives on both tiers)
    std::lock_guard<std::shared_mutex> g(tab->ssd->mu);
    std::vector<uint64_t> disk_keys;
    for (auto& kv : tab->ssd->index)
      if (!mem.count(kv.first)) disk_keys.push_back(kv.first);
    Row row;
    for (uint64_t key : disk_keys) {
      if (!tab->ssd_read_locked(key, row)) continue;
      std::fwrite(&key, 8, 1, f);
      std::fwrite(row.emb.data(), sizeof(float), tab->dim, f);
      std::fwrite(row.state.data(), sizeof(float), tab->dim, f);
      ++count;
    }
  }
  std::fseek(f, count_off, SEEK_SET);
  std::fwrite(&count, 8, 1, f);
  std::fclose(f);
  return 0;
}

int pt_sparse_table_load(void* t, const char* path) {
  auto* tab = static_cast<Table*>(t);
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  uint64_t magic = 0, dim = 0, count = 0;
  if (std::fread(&magic, 8, 1, f) != 1 || magic != 0x50545350u ||
      std::fread(&dim, 8, 1, f) != 1 ||
      dim != static_cast<uint64_t>(tab->dim) ||
      std::fread(&count, 8, 1, f) != 1) {
    std::fclose(f);
    return -2;
  }
  std::vector<float> emb(tab->dim), state(tab->dim);
  for (uint64_t i = 0; i < count; ++i) {
    uint64_t key;
    if (std::fread(&key, 8, 1, f) != 1 ||
        std::fread(emb.data(), sizeof(float), tab->dim, f) !=
            static_cast<size_t>(tab->dim) ||
        std::fread(state.data(), sizeof(float), tab->dim, f) !=
            static_cast<size_t>(tab->dim)) {
      std::fclose(f);
      return -3;
    }
    Shard& s = tab->shard_of(key);
    std::lock_guard<std::mutex> g(s.mu);
    auto it = s.map.find(key);
    // as in assign: fault in a spilled row so live show/click stats are
    // preserved regardless of which tier held the row pre-load (header
    // only — emb/state are overwritten from the checkpoint right below)
    if (it == s.map.end()) it = tab->fault_in(s, key, /*with_payload=*/false);
    if (it == s.map.end()) it = s.map.emplace(key, Row{}).first;
    Row& row = it->second;
    row.emb = emb;
    row.state = state;
    row.version = ++tab->global_version;  // mutation: see assign
    if (tab->ssd) {  // loaded row supersedes any stale disk record
      std::lock_guard<std::shared_mutex> g2(tab->ssd->mu);
      tab->ssd->index.erase(key);
    }
  }
  std::fclose(f);
  return 0;
}

// ---- SSD overflow tier (ssd_sparse_table.cc analog) ----

int pt_sparse_table_enable_ssd(void* t, const char* path) {
  auto* tab = static_cast<Table*>(t);
  auto tier = std::make_unique<DiskTier>();
  tier->path = path;
  tier->f = std::fopen(path, "w+b");
  if (!tier->f) return -1;
  tab->ssd = std::move(tier);
  return 0;
}

// Evict the coldest rows (oldest push version) beyond `max_mem_rows` to the
// disk log. Rows touched since the eviction snapshot stay resident. Returns
// rows evicted, or -2 on disk IO failure (rows whose append failed remain
// resident in memory — never erased on a failed write).
int64_t pt_sparse_table_spill(void* t, int64_t max_mem_rows) {
  auto* tab = static_cast<Table*>(t);
  if (!tab->ssd || max_mem_rows < 0) return -1;
  std::lock_guard<std::mutex> maint(tab->maint_mu);
  std::vector<std::pair<uint64_t, uint64_t>> vk;  // (version, key)
  for (auto& s : tab->shards) {
    std::lock_guard<std::mutex> g(s.mu);
    for (auto& kv : s.map) vk.emplace_back(kv.second.version, kv.first);
  }
  if (static_cast<int64_t>(vk.size()) <= max_mem_rows) return 0;
  int64_t need = static_cast<int64_t>(vk.size()) - max_mem_rows;
  std::nth_element(vk.begin(), vk.begin() + need, vk.end());
  // Pass A: append candidate rows to the log UNFLUSHED and UNPUBLISHED —
  // the rows stay memory-resident, so no reader consults the pending
  // records. One fflush then covers the whole batch (one syscall instead
  // of one per ~80-byte row). Pass B publishes each index entry and
  // erases the memory copy under the same shard lock, re-verifying the
  // version: a row pushed meanwhile stays resident and its orphaned
  // record is unindexed garbage that compact reclaims.
  struct Pending { uint64_t key, version, off; };
  std::vector<Pending> pend;
  pend.reserve(static_cast<size_t>(need));
  for (int64_t i = 0; i < need; ++i) {
    uint64_t snap_version = vk[i].first, key = vk[i].second;
    Shard& s = tab->shard_of(key);
    std::lock_guard<std::mutex> g(s.mu);
    auto it = s.map.find(key);
    if (it == s.map.end() || it->second.version != snap_version) continue;
    uint64_t off;
    bool written;
    {
      std::lock_guard<std::shared_mutex> g2(tab->ssd->mu);
      written = tab->ssd_append_raw_locked(key, it->second, &off);
    }
    if (!written) return -2;  // disk full/IO error: keep the memory copy
    pend.push_back({key, snap_version, off});
  }
  {
    std::lock_guard<std::shared_mutex> g2(tab->ssd->mu);
    if (tab->ssd->f && std::fflush(tab->ssd->f) != 0) return -2;
  }
  int64_t evicted = 0;
  for (const Pending& p : pend) {
    Shard& s = tab->shard_of(p.key);
    std::lock_guard<std::mutex> g(s.mu);
    auto it = s.map.find(p.key);
    if (it == s.map.end() || it->second.version != p.version) continue;
    {
      std::lock_guard<std::shared_mutex> g2(tab->ssd->mu);
      tab->ssd->index[p.key] = p.off;
    }
    s.map.erase(it);
    ++evicted;
  }
  return evicted;
}

// Rewrite the log keeping one live record per disk-only key (stale records
// from re-spills/faults/shrink are garbage). Returns live record count, or
// negative on IO error.
int64_t pt_sparse_table_ssd_compact(void* t) {
  auto* tab = static_cast<Table*>(t);
  if (!tab->ssd) return -1;
  // maint_mu: a concurrent spill between the mem snapshot and the index
  // rewrite would move a row to disk that compact then drops as
  // "memory-resident" — the row would vanish from both tiers
  std::lock_guard<std::mutex> maint(tab->maint_mu);
  auto mem = mem_key_snapshot(tab);
  std::lock_guard<std::shared_mutex> g(tab->ssd->mu);
  std::string tmp = tab->ssd->path + ".tmp";
  FILE* nf = std::fopen(tmp.c_str(), "w+b");
  if (!nf) return -2;
  std::unordered_map<uint64_t, uint64_t> new_index;
  Row row;
  for (auto& kv : tab->ssd->index) {
    if (mem.count(kv.first)) continue;  // memory copy is authoritative
    if (!tab->ssd_read_locked(kv.first, row)) continue;
    std::fseek(nf, 0, SEEK_END);
    uint64_t off = static_cast<uint64_t>(std::ftell(nf));
    size_t ok = 0;
    ok += std::fwrite(&kv.first, 8, 1, nf);
    ok += std::fwrite(&row.version, 8, 1, nf);
    ok += std::fwrite(&row.show, 4, 1, nf);
    ok += std::fwrite(&row.click, 4, 1, nf);
    ok += (std::fwrite(row.emb.data(), sizeof(float), tab->dim, nf) ==
           static_cast<size_t>(tab->dim));
    ok += (std::fwrite(row.state.data(), sizeof(float), tab->dim, nf) ==
           static_cast<size_t>(tab->dim));
    if (ok != 6) {
      // short write (disk full): keep the intact old log, discard the tmp
      std::fclose(nf);
      std::remove(tmp.c_str());
      return -4;
    }
    new_index[kv.first] = off;
  }
  // flush the rewritten log BEFORE publishing its index: pread readers
  // bypass the stdio buffer, so an unflushed record would read short and
  // a fault would mistake a live row for missing
  if (std::fflush(nf) != 0) {
    std::fclose(nf);
    std::remove(tmp.c_str());
    return -4;
  }
  std::fclose(tab->ssd->f);
  if (std::rename(tmp.c_str(), tab->ssd->path.c_str()) != 0) {
    // old log is gone from the handle but still on disk; reopen it and
    // discard the tmp file. A failed reopen leaves f null — the ssd_*
    // helpers treat that as "tier unavailable" rather than crashing.
    tab->ssd->f = std::fopen(tab->ssd->path.c_str(), "r+b");
    std::fclose(nf);
    std::remove(tmp.c_str());
    return -3;
  }
  tab->ssd->f = nf;
  tab->ssd->index = std::move(new_index);
  return static_cast<int64_t>(tab->ssd->index.size());
}

int64_t pt_sparse_table_ssd_rows(void* t) {
  auto* tab = static_cast<Table*>(t);
  if (!tab->ssd) return 0;
  auto mem = mem_key_snapshot(tab);
  std::shared_lock<std::shared_mutex> g(tab->ssd->mu);
  int64_t n = 0;
  for (auto& kv : tab->ssd->index)
    if (!mem.count(kv.first)) ++n;
  return n;
}

}  // extern "C"
