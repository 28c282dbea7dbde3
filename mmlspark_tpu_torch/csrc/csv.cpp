// CSV -> float32 parser and chunked float32 appender for mmlspark_tpu_torch.
//
// Copies of mm_csv_parse_f32, mm_csv_shape and the mm_chunked_* functions
// from the JAX package's native data plane (native/mmlspark_native.cpp),
// kept verbatim so that the port's parsed matrices are the reference's bit
// for bit.  kernels/_build.py compiles this file with binning.cpp and
// murmur.cpp into the host library; utils/native_loader.py binds it with
// ctypes (csv_to_matrix_native, ChunkedArray).

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// CSV -> float32 columnar parser (numeric matrices; NaN for empty/bad cells)
// ---------------------------------------------------------------------------

// Parses `len` bytes of CSV with `ncols` columns into out (row-major,
// nrows_cap rows).  Returns rows parsed, or -1 on overflow.  Fast path for
// the framework's tabular ingest: no quoting support (numeric files).
int64_t mm_csv_parse_f32(const char* buf, int64_t len, int64_t ncols,
                         float* out, int64_t nrows_cap, int skip_header) {
  int64_t pos = 0, row = 0, col = 0;
  if (skip_header) {
    while (pos < len && buf[pos] != '\n') pos++;
    if (pos < len) pos++;
  }
  const char* p = buf + pos;
  const char* end = buf + len;
  while (p < end) {
    if (row >= nrows_cap) return -1;
    // parse one cell
    const char* cell_start = p;
    while (p < end && *p != ',' && *p != '\n' && *p != '\r') p++;
    if (p == cell_start) {
      out[row * ncols + col] = NAN;
    } else {
      char tmp[64];
      int64_t m = p - cell_start;
      if (m > 63) m = 63;
      std::memcpy(tmp, cell_start, m);
      tmp[m] = 0;
      char* endp = nullptr;
      double v = std::strtod(tmp, &endp);
      out[row * ncols + col] = (endp == tmp) ? NAN : static_cast<float>(v);
    }
    col++;
    if (p < end && *p == ',') {
      p++;
      continue;
    }
    // line end
    while (p < end && (*p == '\r' || *p == '\n')) {
      if (*p == '\n') {
        while (col < ncols) out[row * ncols + col++] = NAN;
        row++;
        col = 0;
      }
      p++;
    }
    if (p >= end && col > 0) {  // last line without newline
      while (col < ncols) out[row * ncols + col++] = NAN;
      row++;
      col = 0;
    }
  }
  return row;
}

// Count rows/cols of a CSV buffer (cols from first line).
void mm_csv_shape(const char* buf, int64_t len, int64_t* nrows, int64_t* ncols) {
  int64_t rows = 0, cols = 1;
  bool first = true, line_nonempty = false;
  for (int64_t i = 0; i < len; i++) {
    if (buf[i] == ',' && first) cols++;
    if (buf[i] == '\n') {
      if (line_nonempty || i > 0) rows++;
      first = false;
      line_nonempty = false;
    } else if (buf[i] != '\r') {
      line_nonempty = true;
    }
  }
  if (line_nonempty) rows++;
  *nrows = rows;
  *ncols = cols;
}

// ---------------------------------------------------------------------------
// Chunked column appender (DatasetAggregator analogue): accumulate float32
// values in growable chunks without Python-loop overhead, then coalesce.
// ---------------------------------------------------------------------------

struct MMChunkedArray {
  float* data;
  int64_t size;
  int64_t cap;
};

void* mm_chunked_new(int64_t initial_cap) {
  auto* a = new MMChunkedArray();
  a->cap = initial_cap > 0 ? initial_cap : 1024;
  a->size = 0;
  a->data = static_cast<float*>(std::malloc(sizeof(float) * a->cap));
  return a;
}

void mm_chunked_add(void* handle, const float* values, int64_t n) {
  auto* a = static_cast<MMChunkedArray*>(handle);
  while (a->size + n > a->cap) {
    a->cap *= 2;
    a->data = static_cast<float*>(std::realloc(a->data, sizeof(float) * a->cap));
  }
  std::memcpy(a->data + a->size, values, sizeof(float) * n);
  a->size += n;
}

int64_t mm_chunked_size(void* handle) {
  return static_cast<MMChunkedArray*>(handle)->size;
}

void mm_chunked_coalesce(void* handle, float* out) {
  auto* a = static_cast<MMChunkedArray*>(handle);
  std::memcpy(out, a->data, sizeof(float) * a->size);
}

void mm_chunked_free(void* handle) {
  auto* a = static_cast<MMChunkedArray*>(handle);
  std::free(a->data);
  delete a;
}

}  // extern "C"
