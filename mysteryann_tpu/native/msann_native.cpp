// Native host-side runtime: index (de)serialization and adjacency packing.
//
// Counterpart of the reference's C++ persistence layer
// (reference src/index_bipartite.cpp:2606-2619 SaveProjectionGraph,
// :2097-2117 LoadProjectionGraph, :2045-2071 bipartite Save/Load) and of
// its aligned loaders (include/efanna2e/util.h:180-211): the device wants
// dense sentinel-padded int32 adjacency, the disk format is ragged
// [deg][ids...] — these loops are pure pointer arithmetic and belong in
// C++, not Python (a 10M-node save is ~10M tiny writes).
//
// Exposed as a C ABI for ctypes. All functions return 0 on success,
// negative errno-style codes on failure.

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {

// ---- fbin/ibin -------------------------------------------------------------

int msann_read_header(const char* path, uint32_t* n, uint32_t* d) {
  FILE* f = fopen(path, "rb");
  if (!f) return -errno;
  int ok = fread(n, 4, 1, f) == 1 && fread(d, 4, 1, f) == 1;
  fclose(f);
  return ok ? 0 : -EIO;
}

// ---- projection graph ------------------------------------------------------

// Save: [ep u32][npts u32] then per node [deg u32][ids u32...].
// neighbors: int32 [n, m_pad] with sentinel >= n marking padding.
int msann_save_projection(const char* path, uint32_t ep, uint32_t n,
                          const int32_t* neighbors, uint32_t m_pad) {
  FILE* f = fopen(path, "wb");
  if (!f) return -errno;
  setvbuf(f, nullptr, _IOFBF, 1 << 22);
  if (fwrite(&ep, 4, 1, f) != 1 || fwrite(&n, 4, 1, f) != 1) {
    fclose(f);
    return -EIO;
  }
  std::vector<uint32_t> row(m_pad);
  for (uint32_t i = 0; i < n; ++i) {
    const int32_t* src = neighbors + (size_t)i * m_pad;
    uint32_t deg = 0;
    for (uint32_t j = 0; j < m_pad; ++j) {
      if (src[j] >= 0 && (uint32_t)src[j] < n) row[deg++] = (uint32_t)src[j];
    }
    if (fwrite(&deg, 4, 1, f) != 1 ||
        (deg && fwrite(row.data(), 4, deg, f) != deg)) {
      fclose(f);
      return -EIO;
    }
  }
  fclose(f);
  return 0;
}

// Load pass 1: scan the ragged payload for (npts, max_degree).
int msann_scan_projection(const char* path, uint32_t* ep, uint32_t* n,
                          uint32_t* max_deg, int64_t* payload_words) {
  FILE* f = fopen(path, "rb");
  if (!f) return -errno;
  if (fread(ep, 4, 1, f) != 1 || fread(n, 4, 1, f) != 1) {
    fclose(f);
    return -EIO;
  }
  uint32_t md = 0;
  int64_t words = 0;
  for (uint32_t i = 0; i < *n; ++i) {
    uint32_t deg;
    if (fread(&deg, 4, 1, f) != 1) { fclose(f); return -EIO; }
    if (deg > md) md = deg;
    if (fseek(f, (long)deg * 4, SEEK_CUR) != 0) { fclose(f); return -EIO; }
    words += 1 + deg;
  }
  // reject trailing bytes (same check the Python loader applies)
  long pos = ftell(f);
  fseek(f, 0, SEEK_END);
  if (ftell(f) != pos) { fclose(f); return -EINVAL; }
  *max_deg = md;
  *payload_words = words;
  fclose(f);
  return 0;
}

// Load pass 2: fill the padded adjacency (caller allocates [n, m_pad]).
int msann_load_projection(const char* path, int32_t* neighbors, uint32_t n,
                          uint32_t m_pad) {
  FILE* f = fopen(path, "rb");
  if (!f) return -errno;
  setvbuf(f, nullptr, _IOFBF, 1 << 22);
  fseek(f, 8, SEEK_SET);
  std::vector<uint32_t> row;
  for (uint32_t i = 0; i < n; ++i) {
    uint32_t deg;
    if (fread(&deg, 4, 1, f) != 1) { fclose(f); return -EIO; }
    row.resize(deg);
    if (deg && fread(row.data(), 4, deg, f) != deg) {
      fclose(f);
      return -EIO;
    }
    int32_t* dst = neighbors + (size_t)i * m_pad;
    uint32_t take = deg < m_pad ? deg : m_pad;
    for (uint32_t j = 0; j < take; ++j) dst[j] = (int32_t)row[j];
    for (uint32_t j = take; j < m_pad; ++j) dst[j] = (int32_t)n;
  }
  fclose(f);
  return 0;
}

// ---- bipartite graph (format: [total u32] + per node [deg][ids...]) --------

int msann_save_bipartite(const char* path, uint32_t n_total,
                         const int32_t* neighbors, uint32_t m_pad) {
  FILE* f = fopen(path, "wb");
  if (!f) return -errno;
  setvbuf(f, nullptr, _IOFBF, 1 << 22);
  if (fwrite(&n_total, 4, 1, f) != 1) { fclose(f); return -EIO; }
  std::vector<uint32_t> row(m_pad);
  for (uint32_t i = 0; i < n_total; ++i) {
    const int32_t* src = neighbors + (size_t)i * m_pad;
    uint32_t deg = 0;
    for (uint32_t j = 0; j < m_pad; ++j) {
      if (src[j] >= 0 && (uint32_t)src[j] < n_total)
        row[deg++] = (uint32_t)src[j];
    }
    if (fwrite(&deg, 4, 1, f) != 1 ||
        (deg && fwrite(row.data(), 4, deg, f) != deg)) {
      fclose(f);
      return -EIO;
    }
  }
  fclose(f);
  return 0;
}

int msann_scan_bipartite(const char* path, uint32_t* n_total,
                         uint32_t* max_deg) {
  FILE* f = fopen(path, "rb");
  if (!f) return -errno;
  if (fread(n_total, 4, 1, f) != 1) { fclose(f); return -EIO; }
  uint32_t md = 0;
  for (uint32_t i = 0; i < *n_total; ++i) {
    uint32_t deg;
    if (fread(&deg, 4, 1, f) != 1) { fclose(f); return -EIO; }
    if (deg > md) md = deg;
    if (fseek(f, (long)deg * 4, SEEK_CUR) != 0) { fclose(f); return -EIO; }
  }
  long pos = ftell(f);
  fseek(f, 0, SEEK_END);
  if (ftell(f) != pos) { fclose(f); return -EINVAL; }
  *max_deg = md;
  fclose(f);
  return 0;
}

int msann_load_bipartite(const char* path, int32_t* neighbors,
                         uint32_t n_total, uint32_t m_pad) {
  FILE* f = fopen(path, "rb");
  if (!f) return -errno;
  setvbuf(f, nullptr, _IOFBF, 1 << 22);
  fseek(f, 4, SEEK_SET);
  std::vector<uint32_t> row;
  for (uint32_t i = 0; i < n_total; ++i) {
    uint32_t deg;
    if (fread(&deg, 4, 1, f) != 1) { fclose(f); return -EIO; }
    row.resize(deg);
    if (deg && fread(row.data(), 4, deg, f) != deg) {
      fclose(f);
      return -EIO;
    }
    int32_t* dst = neighbors + (size_t)i * m_pad;
    uint32_t take = deg < m_pad ? deg : m_pad;
    for (uint32_t j = 0; j < take; ++j) dst[j] = (int32_t)row[j];
    for (uint32_t j = take; j < m_pad; ++j) dst[j] = (int32_t)n_total;
  }
  fclose(f);
  return 0;
}

}  // extern "C"

// ---- streaming chunk reader --------------------------------------------
// Double-buffered prefetch: a reader thread fills one buffer from disk
// while the consumer drains the other — overlapping file IO with the
// host->device transfers that follow (the reference loads whole files
// up front, util.h:180-211; a 100M-scale corpus wants a pipeline).

#include <condition_variable>
#include <mutex>
#include <thread>

namespace {

struct MsannStream {
  FILE* f = nullptr;
  uint32_t n = 0, d = 0, elt = 4, chunk_rows = 0;
  uint64_t row_bytes = 0, next_row = 0;

  std::vector<char> buf[2];
  uint64_t rows_in[2] = {0, 0};
  bool ready[2] = {false, false};
  bool eof = false, error = false, stop = false;
  int fill_slot = 0;   // producer's next slot
  int read_slot = 0;   // consumer's next slot (slots drain in fill order)

  std::thread th;
  std::mutex mu;
  std::condition_variable cv;

  void run() {
    for (;;) {
      int s;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return stop || !ready[fill_slot]; });
        if (stop) return;
        s = fill_slot;
      }
      uint64_t want = chunk_rows;
      if (next_row + want > n) want = n - next_row;
      uint64_t got = 0;
      if (want > 0)
        got = fread(buf[s].data(), row_bytes, want, f);
      {
        std::lock_guard<std::mutex> lk(mu);
        rows_in[s] = got;
        ready[s] = true;
        if (got < want) error = true;
        if (got == 0 || next_row + got >= n) eof = true;
        next_row += got;
        fill_slot = 1 - s;
        cv.notify_all();
        if (eof || error) return;
      }
    }
  }
};

}  // namespace

extern "C" {

void* msann_stream_open(const char* path, uint32_t chunk_rows,
                        uint32_t elt_size) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* st = new MsannStream();
  st->f = f;
  if (fread(&st->n, 4, 1, f) != 1 || fread(&st->d, 4, 1, f) != 1) {
    fclose(f);
    delete st;
    return nullptr;
  }
  st->elt = elt_size;
  st->chunk_rows = chunk_rows;
  st->row_bytes = (uint64_t)st->d * elt_size;
  st->buf[0].resize(st->row_bytes * chunk_rows);
  st->buf[1].resize(st->row_bytes * chunk_rows);
  st->th = std::thread([st] { st->run(); });
  return st;
}

int msann_stream_meta(void* h, uint32_t* n, uint32_t* d) {
  auto* st = static_cast<MsannStream*>(h);
  if (!st) return -EINVAL;
  *n = st->n;
  *d = st->d;
  return 0;
}

// Copy the next chunk into `out` (capacity chunk_rows * d * elt bytes).
// Returns rows copied; 0 = end of stream; negative = IO error.
int64_t msann_stream_next(void* h, void* out) {
  auto* st = static_cast<MsannStream*>(h);
  if (!st) return -EINVAL;
  int s;
  {
    std::unique_lock<std::mutex> lk(st->mu);
    s = st->read_slot;
    st->cv.wait(lk, [&] {
      return st->ready[s] || st->eof || st->error;
    });
    if (!st->ready[s]) return st->error ? -EIO : 0;
  }
  uint64_t rows = st->rows_in[s];
  if (rows > 0)
    memcpy(out, st->buf[s].data(), rows * st->row_bytes);
  {
    std::lock_guard<std::mutex> lk(st->mu);
    st->ready[s] = false;
    st->read_slot = 1 - s;
    st->cv.notify_all();
  }
  return (int64_t)rows;
}

void msann_stream_close(void* h) {
  auto* st = static_cast<MsannStream*>(h);
  if (!st) return;
  {
    std::lock_guard<std::mutex> lk(st->mu);
    st->stop = true;
    st->cv.notify_all();
  }
  if (st->th.joinable()) st->th.join();
  fclose(st->f);
  delete st;
}

}  // extern "C"
