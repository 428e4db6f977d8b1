// Threaded Kaldi feature-batch reader of robust_e2e_gan_torch's host
// library.
//
// The per-batch host work of a feats.scp source is N random-access ark
// reads, often CompressedMatrix decompression, and the pad. This reader
// seeks each scp offset, decodes binary FM/DM blobs and all three
// CompressedMatrix formats (CM per-column percentile codes, CM2 u16, CM3
// u8; data/kaldi_io.py documents the format) and streams rows straight
// into the caller-allocated (N, pad_to, dim) float32 batch, one entry at a
// time on each of n_threads threads. Bound by ctypes (utils/native.py);
// data/dataset.py keeps the numpy reader as the plain version. The same C
// entry point, and the same arithmetic, as the JAX package's
// csrc/kaldi_reader.cpp.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

bool read_u16(FILE* f, uint16_t* v) {
  unsigned char b[2];
  if (fread(b, 1, 2, f) != 2) return false;
  *v = (uint16_t)(b[0] | (b[1] << 8));
  return true;
}

bool read_i32(FILE* f, int32_t* v) {
  unsigned char b[4];
  if (fread(b, 1, 4, f) != 4) return false;
  *v = (int32_t)(b[0] | (b[1] << 8) | (b[2] << 16) | ((uint32_t)b[3] << 24));
  return true;
}

bool read_f32(FILE* f, float* v) {
  return fread(v, 4, 1, f) == 1;
}

// \4-prefixed int32 (Kaldi basic-type convention)
bool read_sized_i32(FILE* f, int32_t* v) {
  int c = fgetc(f);
  if (c != 4) return false;
  return read_i32(f, v);
}

// Decode one matrix blob at the current position into out (pad_to, dim),
// zero-padding rows past the matrix. Returns true row count or -1.
int64_t load_blob(FILE* f, float* out, int64_t pad_to, int64_t dim) {
  unsigned char magic[2];
  if (fread(magic, 1, 2, f) != 2 || magic[0] != 0 || magic[1] != 'B')
    return -1;
  char token[8] = {0};
  int ti = 0;
  for (; ti < 7; ++ti) {
    int c = fgetc(f);
    if (c == EOF) return -1;
    if (c == ' ') break;
    token[ti] = (char)c;
  }

  if (strcmp(token, "FM") == 0 || strcmp(token, "DM") == 0) {
    int32_t rows = 0, cols = 0;
    if (!read_sized_i32(f, &rows) || !read_sized_i32(f, &cols)) return -1;
    if (cols != dim || rows < 0) return -1;
    const int64_t n = rows < pad_to ? rows : pad_to;
    if (token[0] == 'F') {
      if ((int64_t)fread(out, 4, n * dim, f) != n * dim) return -1;
    } else {
      std::vector<double> tmp(n * dim);
      if ((int64_t)fread(tmp.data(), 8, n * dim, f) != n * dim) return -1;
      for (int64_t i = 0; i < n * dim; ++i) out[i] = (float)tmp[i];
    }
    memset(out + n * dim, 0, (pad_to - n) * dim * sizeof(float));
    return rows;
  }

  if (strncmp(token, "CM", 2) == 0) {
    const int fmt = token[2] == '2' ? 2 : token[2] == '3' ? 3 : 1;
    float min_v = 0, range = 0;
    int32_t rows = 0, cols = 0;
    if (!read_f32(f, &min_v) || !read_f32(f, &range)) return -1;
    if (!read_i32(f, &rows) || !read_i32(f, &cols)) return -1;
    if (cols != dim || rows < 0) return -1;
    const int64_t n = rows < pad_to ? rows : pad_to;

    if (fmt == 2) {
      std::vector<uint16_t> data(n * dim);
      if ((int64_t)fread(data.data(), 2, n * dim, f) != n * dim) return -1;
      for (int64_t i = 0; i < n * dim; ++i)
        out[i] = min_v + range * (float)data[i] * (1.0f / 65535.0f);
    } else if (fmt == 3) {
      std::vector<uint8_t> data(n * dim);
      if ((int64_t)fread(data.data(), 1, n * dim, f) != n * dim) return -1;
      for (int64_t i = 0; i < n * dim; ++i)
        out[i] = min_v + range * (float)data[i] * (1.0f / 255.0f);
    } else {
      // format 1: per-column percentile headers, column-major u8 codes
      std::vector<uint16_t> hdr(cols * 4);
      if ((int64_t)fread(hdr.data(), 2, cols * 4, f) != cols * 4) return -1;
      std::vector<uint8_t> codes((int64_t)rows * cols);
      if ((int64_t)fread(codes.data(), 1, (int64_t)rows * cols, f) !=
          (int64_t)rows * cols)
        return -1;
      for (int64_t c = 0; c < cols; ++c) {
        const double p0 = min_v + range * hdr[c * 4 + 0] / 65535.0;
        const double p25 = min_v + range * hdr[c * 4 + 1] / 65535.0;
        const double p75 = min_v + range * hdr[c * 4 + 2] / 65535.0;
        const double p100 = min_v + range * hdr[c * 4 + 3] / 65535.0;
        const uint8_t* col = codes.data() + c * rows;
        for (int64_t r = 0; r < n; ++r) {
          const double v = (double)col[r];
          double x;
          if (v <= 64.0)
            x = p0 + (p25 - p0) * (v / 64.0);
          else if (v <= 192.0)
            x = p25 + (p75 - p25) * ((v - 64.0) / 128.0);
          else
            x = p75 + (p100 - p75) * ((v - 192.0) / 63.0);
          out[r * dim + c] = (float)x;
        }
      }
    }
    memset(out + n * dim, 0, (pad_to - n) * dim * sizeof(float));
    return rows;
  }
  return -1;
}

int64_t load_feats_one(const char* path, int64_t offset, float* out,
                       int64_t pad_to, int64_t dim) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  if (fseek(f, (long)offset, SEEK_SET) != 0) {
    fclose(f);
    return -1;
  }
  const int64_t rows = load_blob(f, out, pad_to, dim);
  fclose(f);
  return rows;
}

}  // namespace

extern "C" {

// Load n Kaldi feature matrices (ark paths + scp byte offsets) into out
// (n, pad_to, dim) float32, zero-padded; lengths[i] = true row count.
// Threads across entries. Returns 0 or -(i+1) for the first failing entry.
int64_t rg_load_kaldi_feats_batch_f32(const char** paths,
                                      const int64_t* offsets, int64_t n,
                                      float* out, int64_t pad_to,
                                      int64_t dim, int64_t* lengths,
                                      int32_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int64_t> next(0), err(0);
  auto work = [&]() {
    for (;;) {
      const int64_t i = next.fetch_add(1);
      if (i >= n || err.load() != 0) return;
      const int64_t rows =
          load_feats_one(paths[i], offsets[i], out + i * pad_to * dim,
                         pad_to, dim);
      if (rows < 0) {
        int64_t expected = 0;
        err.compare_exchange_strong(expected, -(i + 1));
        return;
      }
      lengths[i] = rows;
    }
  };
  std::vector<std::thread> ts;
  const int32_t k = (int32_t)std::min<int64_t>(n_threads, n);
  for (int32_t t = 0; t < k; ++t) ts.emplace_back(work);
  for (auto& t : ts) t.join();
  return err.load();
}

}  // extern "C"
