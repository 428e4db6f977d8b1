// Threaded .npy batch reader of robust_e2e_gan_torch's host library.
//
// The per-batch host work of a .npy manifest is reading N variable-length
// waveform files and padding them into one (N, pad_to) float32 buffer: the
// inner loop of data/dataset.py::BucketBatcher's collation. This reader
// parses the (v1.x/v2.x) numpy header, streams samples straight into the
// caller-allocated padded batch and zero-fills the tail, one file at a
// time on each of n_threads threads. Bound by ctypes (utils/native.py),
// which releases the GIL for the whole call; data/dataset.py keeps the
// numpy reader as the plain version. The same C entry point as the JAX
// package's csrc/dataloader.cpp.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// Parse a .npy header at the current file position. Returns data byte
// offset and element count; only little-endian f4/f8 1-D (or (N,1)/(1,N))
// arrays are accepted. Returns false on any mismatch.
bool parse_npy_header(FILE* f, int* elem_size, int64_t* count) {
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return false;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return false;
  const int major = magic[6];
  uint32_t hlen = 0;
  if (major == 1) {
    unsigned char b[2];
    if (fread(b, 1, 2, f) != 2) return false;
    hlen = b[0] | (b[1] << 8);
  } else {
    unsigned char b[4];
    if (fread(b, 1, 4, f) != 4) return false;
    hlen = b[0] | (b[1] << 8) | (b[2] << 16) | ((uint32_t)b[3] << 24);
  }
  std::string hdr(hlen, '\0');
  if (fread(&hdr[0], 1, hlen, f) != hlen) return false;

  if (hdr.find("'fortran_order': True") != std::string::npos) return false;
  if (hdr.find("'<f4'") != std::string::npos) *elem_size = 4;
  else if (hdr.find("'<f8'") != std::string::npos) *elem_size = 8;
  else return false;

  const size_t sp = hdr.find("'shape':");
  if (sp == std::string::npos) return false;
  const size_t lp = hdr.find('(', sp);
  const size_t rp = hdr.find(')', lp);
  if (lp == std::string::npos || rp == std::string::npos) return false;
  std::string shape = hdr.substr(lp + 1, rp - lp - 1);
  // accept "N", "N,", "N, 1", "1, N"
  int64_t dims[2] = {1, 1};
  int nd = 0;
  const char* p = shape.c_str();
  while (*p && nd < 2) {
    while (*p == ' ' || *p == ',') ++p;
    if (!*p) break;
    char* end;
    long long v = strtoll(p, &end, 10);
    if (end == p) return false;
    dims[nd++] = (int64_t)v;
    p = end;
  }
  if (nd == 0) return false;
  if (nd == 2 && dims[0] != 1 && dims[1] != 1) return false;
  *count = dims[0] * dims[1];
  return true;
}

// Load one file into out[0:pad_to], truncating/zero-padding; returns the
// number of valid samples or -1.
int64_t load_one(const char* path, float* out, int64_t pad_to) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int elem_size = 0;
  int64_t count = 0;
  if (!parse_npy_header(f, &elem_size, &count)) {
    fclose(f);
    return -1;
  }
  const int64_t n = count < pad_to ? count : pad_to;
  if (elem_size == 4) {
    if ((int64_t)fread(out, 4, n, f) != n) {
      fclose(f);
      return -1;
    }
  } else {
    std::vector<double> tmp(n);
    if ((int64_t)fread(tmp.data(), 8, n, f) != n) {
      fclose(f);
      return -1;
    }
    for (int64_t i = 0; i < n; ++i) out[i] = (float)tmp[i];
  }
  fclose(f);
  memset(out + n, 0, (pad_to - n) * sizeof(float));
  return count;
}

}  // namespace

extern "C" {

// Load n .npy waveform files into out (n, pad_to) float32, zero-padded.
// lengths[i] receives each file's true sample count (clamped to pad_to by
// the caller if needed). Threads across files (I/O + decode parallelism).
// Returns 0 on success, -(i+1) identifying the first failing file.
int64_t rg_load_npy_batch_f32(const char** paths, int64_t n, float* out,
                              int64_t pad_to, int64_t* lengths,
                              int32_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int64_t> next(0), err(0);
  auto work = [&]() {
    for (;;) {
      const int64_t i = next.fetch_add(1);
      if (i >= n || err.load() != 0) return;
      const int64_t c = load_one(paths[i], out + i * pad_to, pad_to);
      if (c < 0) {
        int64_t expected = 0;
        err.compare_exchange_strong(expected, -(i + 1));
        return;
      }
      lengths[i] = c;
    }
  };
  std::vector<std::thread> ts;
  const int32_t k = (int32_t)std::min<int64_t>(n_threads, n);
  for (int32_t t = 0; t < k; ++t) ts.emplace_back(work);
  for (auto& t : ts) t.join();
  return err.load();
}

}  // extern "C"
