// Embedded durable log store — the native bottom layer of the framework.
//
// Capability parity with the reference's LogDevice-backed store layer
// (/root/reference/hstream-store/cbits/hs_logdevice.cpp,
//  cbits/logdevice/hs_writer.cpp, hs_reader.cpp; C surface in
//  include/hs_logdevice.h): integer logids, monotonically increasing
// LSNs, batch appends under one LSN with optional compression, batched
// reads that surface trim gaps exactly once, trim/findTime/isLogEmpty,
// and a small metadata KV (the reference keeps that in LogsConfig +
// VersionedConfigStore — hs_logconfigtypes.cpp,
// hs_versioned_config_store.cpp).
//
// Design (single-node embedded; replication rides above this layer):
//   root/
//     meta.wal            append-only KV oplog, compacted when large
//     logs/<logid>/
//       attrs.json        opaque attrs blob (Python-encoded)
//       trim              decimal trim LSN (atomic rewrite)
//       seg.<n>           data segments, rotated at SEG_BYTES; whole
//                         segments below the trim point are deleted
//
// Batch frame (little-endian):
//   u32 magic 'NSBK' | u32 flags(compression) | u64 lsn | i64 time_ms |
//   u32 nrecs | u32 raw_len | u32 stored_len | u32 crc32(stored) |
//   u32 lens[nrecs] | u8 stored[stored_len]
// A torn tail (crash mid-write) fails magic/crc validation on open and
// the segment is truncated at the last good frame.
//
// Durability: group commit. Appends are written + indexed + visible
// immediately; a flusher thread fsyncs dirty segments every
// sync_interval_ms (default 2) and sync appends wait for their fsync
// ticket — many appender threads amortize one fsync, mirroring the
// reference's completion-callback write path (hs_writer.cpp:36-45).
// The async path (ns_append_async / ns_poll_completions) completes
// tokens only after fsync: the C++ completion queue the Haskell FFI's
// hs_try_putmvar pattern becomes for Python asyncio.

#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <filesystem>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

namespace fs = std::filesystem;

namespace {

constexpr uint32_t MAGIC = 0x4E53424B;  // "NSBK"
constexpr int64_t LSN_MIN = 1;
constexpr uint64_t SEG_BYTES_DEFAULT = 64ull << 20;

enum Comp : uint32_t { COMP_NONE = 0, COMP_ZLIB = 1 };

void set_err(char* err, const std::string& msg) {
  if (err) {
    std::snprintf(err, 256, "%s", msg.c_str());
  }
}

struct IndexEntry {
  int64_t lsn;
  int64_t time_ms;
  uint32_t seg;
  uint64_t offset;  // frame start within segment
};

struct Segment {
  uint32_t n = 0;
  int fd = -1;
  uint64_t size = 0;
  bool dirty = false;
};

struct Log {
  std::string attrs_json = "{}";
  std::vector<IndexEntry> index;  // sorted by lsn (append order)
  int64_t next_lsn = LSN_MIN;
  int64_t trim_lsn = 0;
  std::vector<Segment> segs;      // open segments (all of them; fds lazy)
  fs::path dir;
};

struct Completion {
  uint64_t token;
  int64_t lsn;
};

struct PendingAsync {
  uint64_t logid;
  uint64_t token;
  std::vector<std::string> payloads;
  uint32_t compression;
};

struct Store;

struct Reader {
  Store* store;
  // logid -> {next, until}
  std::map<uint64_t, std::pair<int64_t, int64_t>> cursors;
  int64_t timeout_ms = -1;
};

struct Store {
  fs::path root;
  std::mutex mu;
  std::condition_variable data_cv;    // readers wait for appends
  std::condition_variable flush_cv;   // sync appends wait for fsync
  std::condition_variable compl_cv;   // completion-queue consumers
  std::unordered_map<uint64_t, Log> logs;
  std::map<std::string, std::string> meta;
  int meta_fd = -1;
  uint64_t meta_wal_bytes = 0;
  uint64_t seg_bytes = SEG_BYTES_DEFAULT;

  // group commit
  std::thread flusher;
  std::thread async_worker;
  std::atomic<bool> stopping{false};
  int64_t sync_interval_ms = 2;
  uint64_t write_seq = 0;    // bumped per append
  uint64_t flushed_seq = 0;  // appends with seq <= this are fsynced
  std::deque<PendingAsync> async_q;
  std::condition_variable async_cv;
  std::deque<Completion> completions;

  ~Store() { shutdown(); }

  void shutdown() {
    {
      std::lock_guard<std::mutex> g(mu);
      if (stopping.exchange(true)) return;
    }
    async_cv.notify_all();
    flush_cv.notify_all();
    if (flusher.joinable()) flusher.join();
    if (async_worker.joinable()) async_worker.join();
    std::lock_guard<std::mutex> g(mu);
    flush_locked();
    for (auto& [id, log] : logs)
      for (auto& s : log.segs)
        if (s.fd >= 0) ::close(s.fd);
    if (meta_fd >= 0) ::close(meta_fd);
    meta_fd = -1;
  }

  // ---- helpers (all called with mu held unless noted) ----

  Log* get(uint64_t logid) {
    auto it = logs.find(logid);
    return it == logs.end() ? nullptr : &it->second;
  }

  Segment* active_seg(Log& log) {
    if (log.segs.empty()) {
      add_segment(log, 0);
    }
    return &log.segs.back();
  }

  void add_segment(Log& log, uint32_t n) {
    Segment s;
    s.n = n;
    fs::path p = log.dir / ("seg." + std::to_string(n));
    s.fd = ::open(p.c_str(), O_RDWR | O_CREAT | O_APPEND, 0644);
    s.size = s.fd >= 0 ? (uint64_t)::lseek(s.fd, 0, SEEK_END) : 0;
    log.segs.push_back(s);
  }

  void flush_locked() {
    for (auto& [id, log] : logs)
      for (auto& s : log.segs)
        if (s.dirty && s.fd >= 0) {
          ::fsync(s.fd);
          s.dirty = false;
        }
    flushed_seq = write_seq;
  }

  void flusher_main() {
    std::unique_lock<std::mutex> lk(mu);
    while (!stopping.load()) {
      flush_cv.wait_for(lk, std::chrono::milliseconds(sync_interval_ms));
      if (flushed_seq != write_seq) {
        flush_locked();
        flush_cv.notify_all();
        compl_cv.notify_all();
      }
    }
  }

  void async_main() {
    std::unique_lock<std::mutex> lk(mu);
    while (true) {
      async_cv.wait(lk, [&] { return stopping.load() || !async_q.empty(); });
      if (stopping.load() && async_q.empty()) return;
      PendingAsync job = std::move(async_q.front());
      async_q.pop_front();
      std::vector<const uint8_t*> ptrs;
      std::vector<uint32_t> lens;
      for (auto& p : job.payloads) {
        ptrs.push_back(reinterpret_cast<const uint8_t*>(p.data()));
        lens.push_back((uint32_t)p.size());
      }
      char err[256];
      int64_t lsn = append_locked(job.logid, ptrs, lens, job.compression,
                                  err);
      uint64_t my_seq = write_seq;
      // complete only after the frame is fsynced (group commit)
      while (!stopping.load() && lsn > 0 && flushed_seq < my_seq)
        flush_cv.wait(lk);
      completions.push_back({job.token, lsn});
      compl_cv.notify_all();
    }
  }

  int64_t append_locked(uint64_t logid,
                        const std::vector<const uint8_t*>& ptrs,
                        const std::vector<uint32_t>& lens,
                        uint32_t compression, char* err,
                        int64_t force_time_ms = 0) {
    Log* log = get(logid);
    if (!log) {
      set_err(err, "log not found");
      return -1;
    }
    uint32_t nrecs = (uint32_t)ptrs.size();
    if (nrecs == 0) {
      set_err(err, "empty batch");
      return -1;
    }
    uint64_t raw_len = 0;
    for (auto l : lens) raw_len += l;
    std::string raw;
    raw.reserve(raw_len);
    for (uint32_t i = 0; i < nrecs; i++)
      raw.append(reinterpret_cast<const char*>(ptrs[i]), lens[i]);

    std::string stored;
    uint32_t flags = COMP_NONE;
    if (compression == COMP_ZLIB && raw_len > 0) {
      uLongf bound = compressBound(raw.size());
      stored.resize(bound);
      if (compress2(reinterpret_cast<Bytef*>(&stored[0]), &bound,
                    reinterpret_cast<const Bytef*>(raw.data()), raw.size(),
                    Z_BEST_SPEED) == Z_OK && bound < raw.size()) {
        stored.resize(bound);
        flags = COMP_ZLIB;
      } else {
        stored = raw;
      }
    } else {
      stored = raw;
    }

    int64_t now_ms = force_time_ms;
    if (now_ms == 0)  // 0 = stamp locally; replication passes the
                      // leader's stamp so replicas agree on find_time
      now_ms = (int64_t)std::chrono::duration_cast<
          std::chrono::milliseconds>(std::chrono::system_clock::now()
                                         .time_since_epoch()).count();
    int64_t lsn = log->next_lsn++;
    uint32_t crc = crc32(0, reinterpret_cast<const Bytef*>(stored.data()),
                         stored.size());

    std::string frame;
    frame.reserve(40 + 4 * nrecs + stored.size());
    auto put32 = [&](uint32_t v) { frame.append((char*)&v, 4); };
    auto put64 = [&](uint64_t v) { frame.append((char*)&v, 8); };
    put32(MAGIC);
    put32(flags);
    put64((uint64_t)lsn);
    put64((uint64_t)now_ms);
    put32(nrecs);
    put32((uint32_t)raw_len);
    put32((uint32_t)stored.size());
    put32(crc);
    for (auto l : lens) put32(l);
    frame.append(stored);

    Segment* seg = active_seg(*log);
    if (seg->fd < 0) {
      set_err(err, "segment open failed");
      log->next_lsn--;
      return -1;
    }
    if (seg->size >= seg_bytes) {
      add_segment(*log, seg->n + 1);
      seg = &log->segs.back();
      if (seg->fd < 0) {
        set_err(err, "segment rotate failed");
        log->next_lsn--;
        return -1;
      }
    }
    uint64_t off = seg->size;
    ssize_t w = ::write(seg->fd, frame.data(), frame.size());
    if (w != (ssize_t)frame.size()) {
      // undo partial write so the tail stays frame-aligned
      if (w > 0) {
        if (::ftruncate(seg->fd, (off_t)off) != 0) {
          // can't recover alignment; next open() will truncate the torn
          // frame via crc validation
        }
      }
      set_err(err, "short write");
      log->next_lsn--;
      return -1;
    }
    seg->size += frame.size();
    seg->dirty = true;
    log->index.push_back({lsn, now_ms, seg->n, off});
    write_seq++;
    data_cv.notify_all();
    return lsn;
  }

  // wait (mu held) until the current write_seq is fsynced
  void wait_durable(std::unique_lock<std::mutex>& lk) {
    uint64_t my_seq = write_seq;
    flush_cv.notify_all();  // nudge the flusher
    while (!stopping.load() && flushed_seq < my_seq) flush_cv.wait(lk);
  }

  bool read_frame(Log& log, const IndexEntry& e, std::string* stored,
                  std::vector<uint32_t>* lens, int64_t* time_ms,
                  uint32_t* flags, uint32_t* raw_len) {
    Segment* seg = nullptr;
    for (auto& s : log.segs)
      if (s.n == e.seg) seg = &s;
    if (!seg || seg->fd < 0) return false;
    uint8_t hdr[40];
    if (::pread(seg->fd, hdr, 40, (off_t)e.offset) != 40) return false;
    uint32_t magic, nrecs, stored_len, crc;
    std::memcpy(&magic, hdr, 4);
    std::memcpy(flags, hdr + 4, 4);
    std::memcpy(time_ms, hdr + 16, 8);
    std::memcpy(&nrecs, hdr + 24, 4);
    std::memcpy(raw_len, hdr + 28, 4);
    std::memcpy(&stored_len, hdr + 32, 4);
    std::memcpy(&crc, hdr + 36, 4);
    if (magic != MAGIC) return false;
    lens->resize(nrecs);
    if (nrecs && ::pread(seg->fd, lens->data(), 4ull * nrecs,
                         (off_t)(e.offset + 40)) != (ssize_t)(4ull * nrecs))
      return false;
    stored->resize(stored_len);
    if (stored_len &&
        ::pread(seg->fd, &(*stored)[0], stored_len,
                (off_t)(e.offset + 40 + 4ull * nrecs)) != (ssize_t)stored_len)
      return false;
    return crc32(0, reinterpret_cast<const Bytef*>(stored->data()),
                 stored->size()) == crc;
  }

  // ---- meta WAL ----

  void meta_append(uint8_t op, const std::string& key,
                   const std::string& val) {
    if (meta_fd < 0) return;
    std::string rec;
    uint32_t klen = (uint32_t)key.size(), vlen = (uint32_t)val.size();
    rec.push_back((char)op);
    rec.append((char*)&klen, 4);
    rec.append((char*)&vlen, 4);
    rec.append(key);
    rec.append(val);
    if (::write(meta_fd, rec.data(), rec.size()) == (ssize_t)rec.size()) {
      ::fsync(meta_fd);
      meta_wal_bytes += rec.size();
    }
    if (meta_wal_bytes > (4u << 20)) meta_compact();
  }

  void meta_compact() {
    fs::path tmp = root / "meta.wal.tmp";
    int fd = ::open(tmp.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0644);
    if (fd < 0) return;
    uint64_t total = 0;
    for (auto& [k, v] : meta) {
      std::string rec;
      uint32_t klen = (uint32_t)k.size(), vlen = (uint32_t)v.size();
      rec.push_back((char)1);
      rec.append((char*)&klen, 4);
      rec.append((char*)&vlen, 4);
      rec.append(k);
      rec.append(v);
      if (::write(fd, rec.data(), rec.size()) != (ssize_t)rec.size()) {
        ::close(fd);
        return;
      }
      total += rec.size();
    }
    ::fsync(fd);
    ::close(fd);
    fs::rename(tmp, root / "meta.wal");
    if (meta_fd >= 0) ::close(meta_fd);
    meta_fd = ::open((root / "meta.wal").c_str(),
                     O_WRONLY | O_APPEND, 0644);
    meta_wal_bytes = total;
  }

  void meta_load() {
    fs::path p = root / "meta.wal";
    FILE* f = std::fopen(p.c_str(), "rb");
    if (f) {
      while (true) {
        uint8_t op;
        uint32_t klen, vlen;
        if (std::fread(&op, 1, 1, f) != 1) break;
        if (std::fread(&klen, 4, 1, f) != 1) break;
        if (std::fread(&vlen, 4, 1, f) != 1) break;
        if (klen > (64u << 20) || vlen > (64u << 20)) break;  // corrupt
        std::string k(klen, '\0'), v(vlen, '\0');
        if (klen && std::fread(&k[0], 1, klen, f) != klen) break;
        if (vlen && std::fread(&v[0], 1, vlen, f) != vlen) break;
        meta_wal_bytes += 9 + klen + vlen;
        if (op == 1)
          meta[k] = v;
        else
          meta.erase(k);
      }
      std::fclose(f);
    }
    meta_fd = ::open(p.c_str(), O_WRONLY | O_CREAT | O_APPEND, 0644);
  }

  // ---- open/recovery ----

  void load_log(uint64_t logid, const fs::path& dir) {
    Log log;
    log.dir = dir;
    {
      FILE* f = std::fopen((dir / "attrs.json").c_str(), "rb");
      if (f) {
        char buf[8192];
        size_t n = std::fread(buf, 1, sizeof(buf), f);
        log.attrs_json.assign(buf, n);
        std::fclose(f);
      }
    }
    {
      FILE* f = std::fopen((dir / "trim").c_str(), "rb");
      if (f) {
        long long t = 0;
        if (std::fscanf(f, "%lld", &t) == 1) log.trim_lsn = t;
        std::fclose(f);
      }
    }
    // discover segments in order
    std::vector<uint32_t> seg_ns;
    for (auto& de : fs::directory_iterator(dir)) {
      std::string name = de.path().filename().string();
      if (name.rfind("seg.", 0) == 0)
        seg_ns.push_back((uint32_t)std::stoul(name.substr(4)));
    }
    std::sort(seg_ns.begin(), seg_ns.end());
    for (uint32_t n : seg_ns) {
      add_segment(log, n);
      Segment& seg = log.segs.back();
      if (seg.fd < 0) continue;
      // scan + validate frames; truncate at first bad frame
      uint64_t off = 0;
      uint64_t fsize = seg.size;
      while (off + 40 <= fsize) {
        uint8_t hdr[40];
        if (::pread(seg.fd, hdr, 40, (off_t)off) != 40) break;
        uint32_t magic, nrecs, stored_len, crc;
        uint64_t lsn;
        int64_t tm;
        std::memcpy(&magic, hdr, 4);
        std::memcpy(&lsn, hdr + 8, 8);
        std::memcpy(&tm, hdr + 16, 8);
        std::memcpy(&nrecs, hdr + 24, 4);
        std::memcpy(&stored_len, hdr + 32, 4);
        std::memcpy(&crc, hdr + 36, 4);
        if (magic != MAGIC || nrecs > (16u << 20)) break;
        uint64_t frame_len = 40 + 4ull * nrecs + stored_len;
        if (off + frame_len > fsize) break;  // torn tail
        std::string stored(stored_len, '\0');
        if (stored_len &&
            ::pread(seg.fd, &stored[0], stored_len,
                    (off_t)(off + 40 + 4ull * nrecs)) != (ssize_t)stored_len)
          break;
        if (crc32(0, reinterpret_cast<const Bytef*>(stored.data()),
                  stored.size()) != crc)
          break;
        log.index.push_back({(int64_t)lsn, tm, seg.n, off});
        log.next_lsn = std::max(log.next_lsn, (int64_t)lsn + 1);
        off += frame_len;
      }
      if (off < fsize) {
        // torn tail from a crash: truncate to the last good frame
        if (::ftruncate(seg.fd, (off_t)off) == 0) seg.size = off;
        // reposition append offset (O_APPEND handles it)
      }
    }
    log.next_lsn = std::max(log.next_lsn, log.trim_lsn + 1);
    // drop index entries at/below the persisted trim point (their frames
    // may still be in not-yet-reclaimed segments)
    if (log.trim_lsn > 0) {
      auto it = std::upper_bound(
          log.index.begin(), log.index.end(), log.trim_lsn,
          [](int64_t v, const IndexEntry& e) { return v < e.lsn; });
      log.index.erase(log.index.begin(), it);
    }
    logs.emplace(logid, std::move(log));
  }

  void persist_trim(Log& log) {
    fs::path tmp = log.dir / "trim.tmp";
    FILE* f = std::fopen(tmp.c_str(), "wb");
    if (!f) return;
    std::fprintf(f, "%lld", (long long)log.trim_lsn);
    std::fflush(f);
    ::fsync(fileno(f));
    std::fclose(f);
    fs::rename(tmp, log.dir / "trim");
  }
};

// serialize one read result into out; returns bytes needed (written if fits)
size_t emit_batch(uint8_t* out, size_t cap, size_t off, uint64_t logid,
                  int64_t lsn, int64_t time_ms,
                  const std::vector<uint32_t>& lens,
                  const std::string& raw) {
  size_t need = 1 + 8 + 8 + 8 + 4 + 4ull * lens.size() + raw.size();
  if (off + need <= cap) {
    uint8_t* p = out + off;
    *p++ = 0;
    std::memcpy(p, &logid, 8); p += 8;
    std::memcpy(p, &lsn, 8); p += 8;
    std::memcpy(p, &time_ms, 8); p += 8;
    uint32_t n = (uint32_t)lens.size();
    std::memcpy(p, &n, 4); p += 4;
    std::memcpy(p, lens.data(), 4ull * n); p += 4ull * n;
    std::memcpy(p, raw.data(), raw.size());
  }
  return need;
}

size_t emit_gap(uint8_t* out, size_t cap, size_t off, uint64_t logid,
                uint8_t gap_type, int64_t lo, int64_t hi) {
  size_t need = 1 + 8 + 1 + 8 + 8;
  if (off + need <= cap) {
    uint8_t* p = out + off;
    *p++ = 1;
    std::memcpy(p, &logid, 8); p += 8;
    *p++ = gap_type;
    std::memcpy(p, &lo, 8); p += 8;
    std::memcpy(p, &hi, 8);
  }
  return need;
}

}  // namespace

extern "C" {

void* ns_open(const char* root, char* err) {
  auto* st = new Store();
  st->root = root;
  std::error_code ec;
  fs::create_directories(st->root / "logs", ec);
  if (ec) {
    set_err(err, "create_directories: " + ec.message());
    delete st;
    return nullptr;
  }
  st->meta_load();
  if (st->meta_fd < 0) {
    set_err(err, "meta.wal open failed");
    delete st;
    return nullptr;
  }
  for (auto& de : fs::directory_iterator(st->root / "logs")) {
    if (!de.is_directory()) continue;
    try {
      uint64_t logid = std::stoull(de.path().filename().string());
      st->load_log(logid, de.path());
    } catch (...) {
      // non-numeric dir: ignore
    }
  }
  st->flusher = std::thread([st] { st->flusher_main(); });
  st->async_worker = std::thread([st] { st->async_main(); });
  return st;
}

void ns_close(void* h) {
  auto* st = static_cast<Store*>(h);
  st->shutdown();
  delete st;
}

void ns_set_sync_interval(void* h, int64_t ms) {
  auto* st = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(st->mu);
  st->sync_interval_ms = ms < 0 ? 0 : ms;
}

void ns_set_seg_bytes(void* h, uint64_t n) {
  auto* st = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(st->mu);
  st->seg_bytes = n < (1u << 16) ? (1u << 16) : n;
}

int ns_create_log(void* h, uint64_t logid, const char* attrs_json,
                  char* err) {
  auto* st = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(st->mu);
  if (st->get(logid)) {
    set_err(err, "log exists");
    return -1;
  }
  fs::path dir = st->root / "logs" / std::to_string(logid);
  std::error_code ec;
  fs::create_directories(dir, ec);
  if (ec) {
    set_err(err, ec.message());
    return -1;
  }
  FILE* f = std::fopen((dir / "attrs.json").c_str(), "wb");
  if (f) {
    std::fputs(attrs_json ? attrs_json : "{}", f);
    std::fclose(f);
  }
  Log log;
  log.dir = dir;
  log.attrs_json = attrs_json ? attrs_json : "{}";
  st->logs.emplace(logid, std::move(log));
  return 0;
}

int ns_remove_log(void* h, uint64_t logid, char* err) {
  auto* st = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(st->mu);
  Log* log = st->get(logid);
  if (!log) {
    set_err(err, "log not found");
    return -1;
  }
  for (auto& s : log->segs)
    if (s.fd >= 0) ::close(s.fd);
  std::error_code ec;
  fs::remove_all(log->dir, ec);
  st->logs.erase(logid);
  return 0;
}

int ns_log_exists(void* h, uint64_t logid) {
  auto* st = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(st->mu);
  return st->get(logid) ? 1 : 0;
}

int64_t ns_list_logs(void* h, uint64_t* out, int64_t cap) {
  auto* st = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(st->mu);
  int64_t n = 0;
  for (auto& [id, log] : st->logs) {
    if (n < cap) out[n] = id;
    n++;
  }
  return n;
}

int64_t ns_log_attrs(void* h, uint64_t logid, char* out, int64_t cap) {
  auto* st = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(st->mu);
  Log* log = st->get(logid);
  if (!log) return -1;
  int64_t need = (int64_t)log->attrs_json.size();
  if (need <= cap) std::memcpy(out, log->attrs_json.data(), need);
  return need;
}

int64_t ns_append_batch(void* h, uint64_t logid, const uint8_t* buf,
                        const uint32_t* lens, uint32_t nrecs,
                        int compression, int durable, char* err,
                        int64_t time_ms) {
  auto* st = static_cast<Store*>(h);
  std::unique_lock<std::mutex> lk(st->mu);
  std::vector<const uint8_t*> ptrs(nrecs);
  std::vector<uint32_t> lvec(lens, lens + nrecs);
  uint64_t off = 0;
  for (uint32_t i = 0; i < nrecs; i++) {
    ptrs[i] = buf + off;
    off += lens[i];
  }
  int64_t lsn = st->append_locked(logid, ptrs, lvec,
                                  (uint32_t)compression, err, time_ms);
  if (lsn > 0 && durable) st->wait_durable(lk);
  return lsn;
}

int ns_append_async(void* h, uint64_t logid, const uint8_t* buf,
                    const uint32_t* lens, uint32_t nrecs, int compression,
                    uint64_t token) {
  auto* st = static_cast<Store*>(h);
  PendingAsync job;
  job.logid = logid;
  job.token = token;
  job.compression = (uint32_t)compression;
  uint64_t off = 0;
  for (uint32_t i = 0; i < nrecs; i++) {
    job.payloads.emplace_back(reinterpret_cast<const char*>(buf + off),
                              lens[i]);
    off += lens[i];
  }
  {
    std::lock_guard<std::mutex> g(st->mu);
    if (st->stopping.load()) return -1;
    st->async_q.push_back(std::move(job));
  }
  st->async_cv.notify_one();
  return 0;
}

int64_t ns_poll_completions(void* h, uint64_t* tokens, int64_t* lsns,
                            int64_t maxn, int64_t timeout_ms) {
  auto* st = static_cast<Store*>(h);
  std::unique_lock<std::mutex> lk(st->mu);
  if (st->completions.empty() && timeout_ms != 0) {
    auto pred = [&] {
      return st->stopping.load() || !st->completions.empty();
    };
    if (timeout_ms < 0)
      st->compl_cv.wait(lk, pred);
    else
      st->compl_cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                            pred);
  }
  int64_t n = 0;
  while (n < maxn && !st->completions.empty()) {
    tokens[n] = st->completions.front().token;
    lsns[n] = st->completions.front().lsn;
    st->completions.pop_front();
    n++;
  }
  return n;
}

int64_t ns_tail_lsn(void* h, uint64_t logid) {
  auto* st = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(st->mu);
  Log* log = st->get(logid);
  if (!log) return -1;
  return log->index.empty() ? 0 : log->index.back().lsn;
}

int ns_trim(void* h, uint64_t logid, int64_t upto, char* err) {
  auto* st = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(st->mu);
  Log* log = st->get(logid);
  if (!log) {
    set_err(err, "log not found");
    return -1;
  }
  auto it = std::upper_bound(
      log->index.begin(), log->index.end(), upto,
      [](int64_t v, const IndexEntry& e) { return v < e.lsn; });
  log->index.erase(log->index.begin(), it);
  if (upto > log->trim_lsn) {
    log->trim_lsn = upto;
    st->persist_trim(*log);
  }
  log->next_lsn = std::max(log->next_lsn, log->trim_lsn + 1);
  // delete whole segments now strictly below the live index
  uint32_t live_min = log->index.empty()
                          ? (log->segs.empty() ? 0 : log->segs.back().n)
                          : log->index.front().seg;
  while (!log->segs.empty() && log->segs.front().n < live_min) {
    Segment& s = log->segs.front();
    if (s.fd >= 0) ::close(s.fd);
    std::error_code ec;
    fs::remove(log->dir / ("seg." + std::to_string(s.n)), ec);
    log->segs.erase(log->segs.begin());
  }
  return 0;
}

int64_t ns_trim_point(void* h, uint64_t logid) {
  auto* st = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(st->mu);
  Log* log = st->get(logid);
  return log ? log->trim_lsn : -1;
}

int64_t ns_find_time(void* h, uint64_t logid, int64_t ts_ms) {
  auto* st = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(st->mu);
  Log* log = st->get(logid);
  if (!log) return -1;
  auto it = std::lower_bound(
      log->index.begin(), log->index.end(), ts_ms,
      [](const IndexEntry& e, int64_t v) { return e.time_ms < v; });
  if (it == log->index.end())
    return log->index.empty() ? log->next_lsn
                              : log->index.back().lsn + 1;
  return it->lsn;
}

int ns_is_log_empty(void* h, uint64_t logid) {
  auto* st = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(st->mu);
  Log* log = st->get(logid);
  if (!log) return -1;
  return log->index.empty() ? 1 : 0;
}

// ---- meta KV ----

int ns_meta_put(void* h, const char* key, const uint8_t* val, int64_t len) {
  auto* st = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(st->mu);
  std::string v(reinterpret_cast<const char*>(val), (size_t)len);
  st->meta[key] = v;
  st->meta_append(1, key, v);
  return 0;
}

int64_t ns_meta_get(void* h, const char* key, uint8_t* out, int64_t cap) {
  auto* st = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(st->mu);
  auto it = st->meta.find(key);
  if (it == st->meta.end()) return -1;
  int64_t need = (int64_t)it->second.size();
  if (need <= cap) std::memcpy(out, it->second.data(), need);
  return need;
}

int ns_meta_delete(void* h, const char* key) {
  auto* st = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(st->mu);
  st->meta.erase(key);
  st->meta_append(0, key, "");
  return 0;
}

int64_t ns_meta_list(void* h, const char* prefix, char* out, int64_t cap) {
  auto* st = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(st->mu);
  std::string joined;
  std::string pfx = prefix;
  for (auto it = st->meta.lower_bound(pfx); it != st->meta.end(); ++it) {
    if (it->first.compare(0, pfx.size(), pfx) != 0) break;
    if (!joined.empty()) joined.push_back('\n');
    joined.append(it->first);
  }
  int64_t need = (int64_t)joined.size();
  if (need <= cap) std::memcpy(out, joined.data(), need);
  return need;
}

int ns_meta_cas(void* h, const char* key, const uint8_t* exp,
                int64_t explen, const uint8_t* val, int64_t vlen) {
  auto* st = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(st->mu);
  auto it = st->meta.find(key);
  if (explen < 0) {
    if (it != st->meta.end()) return 0;
  } else {
    std::string e(reinterpret_cast<const char*>(exp), (size_t)explen);
    if (it == st->meta.end() || it->second != e) return 0;
  }
  std::string v(reinterpret_cast<const char*>(val), (size_t)vlen);
  st->meta[key] = v;
  st->meta_append(1, key, v);
  return 1;
}

// ---- reader ----

void* ns_reader_new(void* h) {
  auto* r = new Reader();
  r->store = static_cast<Store*>(h);
  return r;
}

void ns_reader_free(void* rh) { delete static_cast<Reader*>(rh); }

int ns_reader_start(void* rh, uint64_t logid, int64_t from, int64_t until) {
  auto* r = static_cast<Reader*>(rh);
  std::lock_guard<std::mutex> g(r->store->mu);
  if (!r->store->get(logid)) return -1;
  r->cursors[logid] = {std::max(from, LSN_MIN), until};
  return 0;
}

int ns_reader_stop(void* rh, uint64_t logid) {
  auto* r = static_cast<Reader*>(rh);
  std::lock_guard<std::mutex> g(r->store->mu);
  r->cursors.erase(logid);
  return 0;
}

int ns_reader_is_reading(void* rh, uint64_t logid) {
  auto* r = static_cast<Reader*>(rh);
  std::lock_guard<std::mutex> g(r->store->mu);
  return r->cursors.count(logid) ? 1 : 0;
}

void ns_reader_set_timeout(void* rh, int64_t ms) {
  auto* r = static_cast<Reader*>(rh);
  std::lock_guard<std::mutex> g(r->store->mu);
  r->timeout_ms = ms;
}

// Serialized results into out (see emit_batch/emit_gap). Returns bytes
// written; 0 = timeout with nothing available; -need if the FIRST item
// alone exceeds cap (caller grows the buffer and retries).
int64_t ns_reader_read(void* rh, int64_t max_records, uint8_t* out,
                       int64_t cap) {
  auto* r = static_cast<Reader*>(rh);
  Store* st = r->store;
  std::unique_lock<std::mutex> lk(st->mu);

  auto poll = [&](size_t* produced) -> size_t {
    size_t off = 0;
    *produced = 0;
    for (auto& [logid, cur] : r->cursors) {
      auto& [nxt, until] = cur;
      if (nxt > until) continue;
      Log* log = st->get(logid);
      if (!log) continue;
      if (log->trim_lsn >= nxt) {
        int64_t hi = std::min(log->trim_lsn, until);
        size_t need = emit_gap(out, cap, off, logid, 0, nxt, hi);
        if (off + need > (size_t)cap)
          return *produced == 0 ? (size_t)-1 : off;
        off += need;
        nxt = hi + 1;
        (*produced)++;
        if ((int64_t)*produced >= max_records) return off;
      }
      auto it = std::lower_bound(
          log->index.begin(), log->index.end(), nxt,
          [](const IndexEntry& e, int64_t v) { return e.lsn < v; });
      for (; it != log->index.end(); ++it) {
        if (it->lsn > until || (int64_t)*produced >= max_records) break;
        std::string stored;
        std::vector<uint32_t> lens;
        int64_t tm;
        uint32_t flags, raw_len;
        if (!st->read_frame(*log, *it, &stored, &lens, &tm, &flags,
                            &raw_len))
          break;
        std::string raw;
        if (flags == COMP_ZLIB) {
          raw.resize(raw_len);
          uLongf dlen = raw_len;
          if (uncompress(reinterpret_cast<Bytef*>(&raw[0]), &dlen,
                         reinterpret_cast<const Bytef*>(stored.data()),
                         stored.size()) != Z_OK)
            break;
        } else {
          raw = std::move(stored);
        }
        size_t need = emit_batch(out, cap, off, logid, it->lsn, tm, lens,
                                 raw);
        if (off + need > (size_t)cap)
          return *produced == 0 ? (size_t)-1 : off;
        off += need;
        nxt = it->lsn + 1;
        (*produced)++;
      }
      if ((int64_t)*produced >= max_records) break;
    }
    return off;
  };

  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(
                      r->timeout_ms < 0 ? 0 : r->timeout_ms);
  while (true) {
    size_t produced = 0;
    size_t off = poll(&produced);
    if (off == (size_t)-1) {
      // first item doesn't fit: report required size for ONE item pass
      // (conservative: ask for 2x cap)
      return -(cap * 2);
    }
    if (produced > 0) return (int64_t)off;
    if (r->timeout_ms == 0) return 0;
    if (r->timeout_ms < 0) {
      st->data_cv.wait(lk);
    } else {
      if (st->data_cv.wait_until(lk, deadline) == std::cv_status::timeout) {
        size_t p2 = 0;
        size_t o2 = poll(&p2);
        return o2 == (size_t)-1 ? -(cap * 2) : (int64_t)o2;
      }
    }
  }
}

}  // extern "C"
