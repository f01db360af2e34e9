// Fast Matrix Market (.mtx) coordinate parser.
//
// The port's own copy of the JAX package's native parser (reference
// parity: gunrock's vendored mmio.c, io/detail/mmio.cpp), written from the
// public MatrixMarket format spec. Design: single read() of the whole file,
// branch-light hand-rolled int/float scanning (no strtod locale machinery in
// the hot loop), symmetric expansion done in place on the output buffers.
// Built at first use with the host C++ compiler by mmio_native.py.
//
// C ABI for ctypes:
//   etpu_coo* etpu_load_mtx(const char* path, int expand_symmetric)
//   void      etpu_coo_free(etpu_coo*)

#include <cctype>
#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

struct etpu_coo {
  int64_t n_rows;
  int64_t n_cols;
  int64_t nnz;
  int32_t* rows;
  int32_t* cols;
  float* vals;
  char err[256];
};

}  // extern "C"

namespace {

enum class Field { kReal, kInteger, kPattern, kComplex };
enum class Sym { kGeneral, kSymmetric, kSkew, kHermitian };

const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n'))
    ++p;
  return p;
}

// Parse a non-negative integer; returns nullptr on failure.
const char* parse_i64(const char* p, const char* end, int64_t* out) {
  p = skip_ws(p, end);
  if (p >= end || !isdigit((unsigned char)*p)) return nullptr;
  int64_t v = 0;
  while (p < end && isdigit((unsigned char)*p)) v = v * 10 + (*p++ - '0');
  *out = v;
  return p;
}

// Fast float parse: sign, digits, optional fraction/exponent.
const char* parse_f64(const char* p, const char* end, double* out) {
  p = skip_ws(p, end);
  if (p >= end) return nullptr;
  bool neg = false;
  if (*p == '+' || *p == '-') neg = (*p++ == '-');
  double v = 0.0;
  bool any = false;
  while (p < end && isdigit((unsigned char)*p)) {
    v = v * 10.0 + (*p++ - '0');
    any = true;
  }
  if (p < end && *p == '.') {
    ++p;
    double scale = 0.1;
    while (p < end && isdigit((unsigned char)*p)) {
      v += (*p++ - '0') * scale;
      scale *= 0.1;
      any = true;
    }
  }
  if (!any) return nullptr;
  if (p < end && (*p == 'e' || *p == 'E' || *p == 'd' || *p == 'D')) {
    ++p;
    bool eneg = false;
    if (p < end && (*p == '+' || *p == '-')) eneg = (*p++ == '-');
    int64_t ex = 0;
    if (p >= end || !isdigit((unsigned char)*p)) return nullptr;
    while (p < end && isdigit((unsigned char)*p)) ex = ex * 10 + (*p++ - '0');
    v *= std::pow(10.0, eneg ? -ex : ex);
  }
  *out = neg ? -v : v;
  return p;
}

etpu_coo* fail(etpu_coo* c, const char* msg) {
  snprintf(c->err, sizeof(c->err), "%s", msg);
  return c;
}

}  // namespace

extern "C" {

void etpu_coo_free(etpu_coo* c) {
  if (!c) return;
  free(c->rows);
  free(c->cols);
  free(c->vals);
  free(c);
}

etpu_coo* etpu_load_mtx(const char* path, int expand_symmetric) {
  etpu_coo* out = (etpu_coo*)calloc(1, sizeof(etpu_coo));
  if (!out) return nullptr;

  FILE* f = fopen(path, "rb");
  if (!f) return fail(out, "cannot open file");
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf;
  buf.resize((size_t)size);
  if (size > 0 && fread(&buf[0], 1, (size_t)size, f) != (size_t)size) {
    fclose(f);
    return fail(out, "short read");
  }
  fclose(f);

  const char* p = buf.data();
  const char* end = p + buf.size();

  // ---- banner ----
  const char* nl = (const char*)memchr(p, '\n', end - p);
  if (!nl) return fail(out, "missing banner line");
  std::string banner(p, nl);
  for (auto& ch : banner) ch = (char)tolower((unsigned char)ch);
  if (banner.rfind("%%matrixmarket", 0) != 0)
    return fail(out, "not a MatrixMarket banner");
  Field field;
  if (banner.find("real") != std::string::npos) field = Field::kReal;
  else if (banner.find("integer") != std::string::npos) field = Field::kInteger;
  else if (banner.find("pattern") != std::string::npos) field = Field::kPattern;
  else if (banner.find("complex") != std::string::npos) field = Field::kComplex;
  else return fail(out, "unsupported field");
  Sym sym;
  if (banner.find("skew-symmetric") != std::string::npos) sym = Sym::kSkew;
  else if (banner.find("symmetric") != std::string::npos) sym = Sym::kSymmetric;
  else if (banner.find("hermitian") != std::string::npos) sym = Sym::kHermitian;
  else if (banner.find("general") != std::string::npos) sym = Sym::kGeneral;
  else return fail(out, "unsupported symmetry");
  if (banner.find("coordinate") == std::string::npos)
    return fail(out, "native parser handles coordinate format only");
  p = nl + 1;

  // ---- comments + size line ----
  int64_t n_rows = 0, n_cols = 0, nnz = 0;
  while (p < end) {
    p = skip_ws(p, end);
    if (p < end && *p == '%') {
      const char* q = (const char*)memchr(p, '\n', end - p);
      if (!q) return fail(out, "missing size line");
      p = q + 1;
      continue;
    }
    const char* q = parse_i64(p, end, &n_rows);
    if (!q) return fail(out, "bad size line");
    q = parse_i64(q, end, &n_cols);
    if (!q) return fail(out, "bad size line");
    q = parse_i64(q, end, &nnz);
    if (!q) return fail(out, "bad size line");
    p = q;
    break;
  }

  bool expand = expand_symmetric && sym != Sym::kGeneral;
  int64_t cap = expand ? nnz * 2 : nnz;
  if (cap == 0) cap = 1;
  out->rows = (int32_t*)malloc(sizeof(int32_t) * (size_t)cap);
  out->cols = (int32_t*)malloc(sizeof(int32_t) * (size_t)cap);
  out->vals = (float*)malloc(sizeof(float) * (size_t)cap);
  if (!out->rows || !out->cols || !out->vals)
    return fail(out, "allocation failure");

  int64_t k = 0;
  for (int64_t i = 0; i < nnz; ++i) {
    // comments between entries are legal
    p = skip_ws(p, end);
    while (p < end && *p == '%') {
      const char* q = (const char*)memchr(p, '\n', end - p);
      if (!q) return fail(out, "truncated entries");
      p = skip_ws(q + 1, end);
    }
    int64_t r, c;
    const char* q = parse_i64(p, end, &r);
    if (!q) return fail(out, "bad row index");
    q = parse_i64(q, end, &c);
    if (!q) return fail(out, "bad col index");
    double v = 1.0;
    if (field == Field::kReal || field == Field::kInteger) {
      q = parse_f64(q, end, &v);
      if (!q) return fail(out, "bad value");
    } else if (field == Field::kComplex) {
      double im;
      q = parse_f64(q, end, &v);
      if (!q) return fail(out, "bad complex value");
      q = parse_f64(q, end, &im);  // imaginary part dropped (real projection)
      if (!q) return fail(out, "bad complex value");
    }
    p = q;
    out->rows[k] = (int32_t)(r - 1);
    out->cols[k] = (int32_t)(c - 1);
    out->vals[k] = (float)v;
    ++k;
    if (expand && r != c) {
      out->rows[k] = (int32_t)(c - 1);
      out->cols[k] = (int32_t)(r - 1);
      out->vals[k] = (float)(sym == Sym::kSkew ? -v : v);
      ++k;
    }
  }

  out->n_rows = n_rows;
  out->n_cols = n_cols;
  out->nnz = k;
  return out;
}

}  // extern "C"
