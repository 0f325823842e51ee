// Fast ASCII tableaux+distmatrix database parser and size-bucket packer.
//
// Native twin of cuda_satabsearch_tpu/io/{parser,pack}.py, playing the
// role the reference's parsetableaux.c (N7 in SURVEY.md) plays for its
// driver: turn the ASCII DB format into dense packed arrays.  Unlike
// the reference we pack directly into padded size buckets (the device
// layout) in one pass, and we tokenize on whitespace rather than fixed
// column strides (parsetableaux.c:193-294 strides misparse >=100 A
// distances present in real data).
//
// C API (ctypes-friendly): parse+pack a file into per-bucket dense
// arrays owned by an opaque handle; the Python wrapper views them as
// numpy arrays and copies/keeps as needed.

#include <sys/stat.h>

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kLabelSize = 127;  // name buffer (reference LABELSIZE=8;
// the whitespace tokenizer supports arbitrary-length names, so the
// pack path must not silently truncate — names beyond this report an
// error instead)
constexpr int8_t kTypePad = 127;
constexpr float kDmatPad = 1.0e9f;

struct Entry {
  std::string name;
  int order = 0;
  std::vector<int8_t> tabhi, tablo, types;  // order*order / order
  std::vector<float> dmat;                  // order*order
};

struct Bucket {
  int cap = 0;
  int64_t count = 0;
  std::vector<int8_t> tabhi, tablo, types;
  std::vector<float> dmat;
  std::vector<int32_t> orders, index;
  std::vector<char> names;  // count * (kLabelSize+1)
};

struct Db {
  std::vector<Bucket> buckets;
  int64_t nentries = 0;
  int64_t nskipped = 0;
  std::string error;
};

// --- tokenizer over a memory buffer -----------------------------------
struct Lexer {
  const char* p;
  const char* end;
  bool next_token(const char** tok, size_t* len) {
    while (p < end && std::isspace(static_cast<unsigned char>(*p))) ++p;
    if (p >= end) return false;
    const char* start = p;
    while (p < end && !std::isspace(static_cast<unsigned char>(*p))) ++p;
    *tok = start;
    *len = static_cast<size_t>(p - start);
    return true;
  }
  bool next_line_token(const char** tok, size_t* len) {
    // token not crossing a newline (rows are line-structured)
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    if (p >= end || *p == '\n') return false;
    const char* start = p;
    while (p < end && !std::isspace(static_cast<unsigned char>(*p))) ++p;
    *tok = start;
    *len = static_cast<size_t>(p - start);
    return true;
  }
  void skip_to_eol() {
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;
  }
};

// encodings: core/codes.py (same values as parsetableaux.c:14-34)
inline int encode_hi(char c) {
  switch (c) {
    case 'P': return 0;
    case 'R': return 1;
    case 'O': return 2;
    case 'L': return 3;
    case '?': return 4;
    default: return -1;
  }
}
inline int encode_lo(char c) {
  switch (c) {
    case 'E': return 0;
    case 'D': return 1;
    case 'S': return 2;
    case 'T': return 3;
    case '?': return 4;
    default: return -1;
  }
}
inline int encode_ssetype(const char* t, size_t len) {
  if (len == 1 && t[0] == 'e') return 0;
  if (len == 2 && t[0] == 'x') {
    switch (t[1]) {
      case 'a': return 1;
      case 'i': return 2;
      case 'g': return 3;
    }
  }
  return -1;
}

bool parse_entry(Lexer& lx, Entry& e, std::string& err) {
  const char* tok;
  size_t len;
  if (!lx.next_token(&tok, &len)) return false;  // EOF
  e.name.assign(tok, len);
  if (!lx.next_token(&tok, &len)) {
    err = "EOF after name " + e.name;
    return false;
  }
  char* oend;
  e.order = static_cast<int>(std::strtol(tok, &oend, 10));
  if (e.order <= 0 || oend != tok + len) {
    // a partially-numeric token ('5x') must be an error, not 5 — the
    // Python parser raises ValueError on the same input
    err = "bad order for " + e.name;
    return false;
  }
  const int n = e.order;
  e.tabhi.assign(static_cast<size_t>(n) * n, 0);
  e.tablo.assign(static_cast<size_t>(n) * n, 0);
  e.types.assign(n, 0);
  e.dmat.assign(static_cast<size_t>(n) * n, 0.0f);
  lx.skip_to_eol();

  for (int i = 0; i < n; ++i) {
    for (int j = 0; j <= i; ++j) {
      if (!lx.next_line_token(&tok, &len)) {
        err = e.name + ": short tableau row " + std::to_string(i);
        return false;
      }
      if (i == j) {
        int t = encode_ssetype(tok, len);
        if (t < 0) {
          err = e.name + ": bad SSE type " + std::string(tok, len);
          return false;
        }
        e.types[i] = static_cast<int8_t>(t);
        e.tabhi[static_cast<size_t>(i) * n + i] = static_cast<int8_t>(t);
        e.tablo[static_cast<size_t>(i) * n + i] = static_cast<int8_t>(t);
      } else {
        int hi = len == 2 ? encode_hi(tok[0]) : -1;
        int lo = len == 2 ? encode_lo(tok[1]) : -1;
        if (hi < 0 || lo < 0) {
          err = e.name + ": bad tableau code " + std::string(tok, len);
          return false;
        }
        e.tabhi[static_cast<size_t>(i) * n + j] = static_cast<int8_t>(hi);
        e.tabhi[static_cast<size_t>(j) * n + i] = static_cast<int8_t>(hi);
        e.tablo[static_cast<size_t>(i) * n + j] = static_cast<int8_t>(lo);
        e.tablo[static_cast<size_t>(j) * n + i] = static_cast<int8_t>(lo);
      }
    }
    lx.skip_to_eol();
  }
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j <= i; ++j) {
      if (!lx.next_line_token(&tok, &len)) {
        err = e.name + ": short distmatrix row " + std::to_string(i);
        return false;
      }
      char* endp;
      float d = std::strtof(tok, &endp);
      if (endp != tok + len) {
        // reject non-numeric tokens instead of silently storing 0.0
        // (the Python parser raises; distances feed the score kernel)
        err = e.name + ": bad distance token " + std::string(tok, len);
        return false;
      }
      e.dmat[static_cast<size_t>(i) * n + j] = d;
      e.dmat[static_cast<size_t>(j) * n + i] = d;
    }
    lx.skip_to_eol();
  }
  return true;
}

}  // namespace

extern "C" {

// Parse `path` and pack into buckets with the given ascending caps.
// Returns an opaque handle (nullptr on hard I/O error).  Entries larger
// than maxdim are skipped with a warning on stderr
// (parsetableaux.c:457-465 behavior).
void* satab_pack_file(const char* path, int maxdim, const int* caps,
                      int ncaps) try {
  // reject non-regular files up front: fopen() on a directory succeeds
  // on Linux and ftell then reports a bogus huge size whose allocation
  // would throw (and a C++ exception must never cross extern "C" — it
  // aborts the embedding Python process)
  struct stat st;
  if (::stat(path, &st) != 0 || !S_ISREG(st.st_mode)) return nullptr;
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size < 0) {
    std::fclose(f);
    return nullptr;
  }
  // +1 NUL sentinel: strtol/strtof on the file's LAST token must not
  // scan past the allocation when the file lacks a trailing newline
  std::vector<char> buf(static_cast<size_t>(size) + 1, '\0');
  if (size > 0 && std::fread(buf.data(), 1, static_cast<size_t>(size), f) !=
                      static_cast<size_t>(size)) {
    std::fclose(f);
    return nullptr;
  }
  std::fclose(f);

  Db* db = new Db();
  db->buckets.resize(ncaps);
  for (int b = 0; b < ncaps; ++b) db->buckets[b].cap = caps[b];

  // pass 1: parse entries, group by bucket
  std::vector<std::vector<std::pair<int64_t, Entry>>> groups(ncaps);
  Lexer lx{buf.data(), buf.data() + static_cast<size_t>(size)};
  int64_t pos = 0;
  Entry e;
  std::string err;
  while (parse_entry(lx, e, err)) {
    if (e.order > maxdim) {
      std::fprintf(stderr,
                   "WARNING: excluded structure %s as it is too large\n",
                   e.name.c_str());
      ++db->nskipped;
      continue;
    }
    if (static_cast<int>(e.name.size()) > kLabelSize) {
      err = "entry name too long for native pack: " + e.name;
      break;
    }
    bool placed = false;
    for (int b = 0; b < ncaps; ++b) {
      if (e.order <= caps[b]) {
        groups[b].emplace_back(pos, std::move(e));
        placed = true;
        break;
      }
    }
    if (!placed) {
      // order <= maxdim but beyond the last cap: the Python packer
      // raises for this; a silent drop would leave a hole in the DB
      err = "entry " + e.name + " order " + std::to_string(e.order) +
            " exceeds max bucket cap";
      break;
    }
    ++pos;
  }
  if (!err.empty()) {
    db->error = err;
    return db;  // caller inspects satab_error
  }
  db->nentries = pos;

  // pass 2: pack each bucket densely
  for (int b = 0; b < ncaps; ++b) {
    Bucket& bk = db->buckets[b];
    const int cap = bk.cap;
    const int64_t cnt = static_cast<int64_t>(groups[b].size());
    bk.count = cnt;
    if (cnt == 0) continue;
    bk.tabhi.assign(static_cast<size_t>(cnt) * cap * cap, 0);
    bk.tablo.assign(static_cast<size_t>(cnt) * cap * cap, 0);
    bk.types.assign(static_cast<size_t>(cnt) * cap, kTypePad);
    bk.dmat.assign(static_cast<size_t>(cnt) * cap * cap, kDmatPad);
    bk.orders.assign(cnt, 0);
    bk.index.assign(cnt, 0);
    bk.names.assign(static_cast<size_t>(cnt) * (kLabelSize + 1), 0);
    for (int64_t i = 0; i < cnt; ++i) {
      const Entry& en = groups[b][static_cast<size_t>(i)].second;
      const int n = en.order;
      int8_t* th = bk.tabhi.data() + static_cast<size_t>(i) * cap * cap;
      int8_t* tl = bk.tablo.data() + static_cast<size_t>(i) * cap * cap;
      float* dm = bk.dmat.data() + static_cast<size_t>(i) * cap * cap;
      for (int r = 0; r < n; ++r) {
        std::memcpy(th + static_cast<size_t>(r) * cap,
                    en.tabhi.data() + static_cast<size_t>(r) * n, n);
        std::memcpy(tl + static_cast<size_t>(r) * cap,
                    en.tablo.data() + static_cast<size_t>(r) * n, n);
        std::memcpy(dm + static_cast<size_t>(r) * cap,
                    en.dmat.data() + static_cast<size_t>(r) * n,
                    static_cast<size_t>(n) * sizeof(float));
      }
      std::memcpy(bk.types.data() + static_cast<size_t>(i) * cap,
                  en.types.data(), n);
      bk.orders[static_cast<size_t>(i)] = n;
      bk.index[static_cast<size_t>(i)] =
          static_cast<int32_t>(groups[b][static_cast<size_t>(i)].first);
      std::strncpy(bk.names.data() +
                       static_cast<size_t>(i) * (kLabelSize + 1),
                   en.name.c_str(), kLabelSize);
    }
  }
  return db;
} catch (...) {
  // never let a C++ exception cross the extern "C" boundary
  return nullptr;
}

const char* satab_error(void* h) {
  Db* db = static_cast<Db*>(h);
  return db->error.empty() ? nullptr : db->error.c_str();
}
int64_t satab_nentries(void* h) { return static_cast<Db*>(h)->nentries; }
int64_t satab_nskipped(void* h) { return static_cast<Db*>(h)->nskipped; }
int64_t satab_bucket_count(void* h, int b) {
  return static_cast<Db*>(h)->buckets[b].count;
}
int satab_bucket_cap(void* h, int b) {
  return static_cast<Db*>(h)->buckets[b].cap;
}
const int8_t* satab_bucket_tabhi(void* h, int b) {
  return static_cast<Db*>(h)->buckets[b].tabhi.data();
}
const int8_t* satab_bucket_tablo(void* h, int b) {
  return static_cast<Db*>(h)->buckets[b].tablo.data();
}
const int8_t* satab_bucket_types(void* h, int b) {
  return static_cast<Db*>(h)->buckets[b].types.data();
}
const float* satab_bucket_dmat(void* h, int b) {
  return static_cast<Db*>(h)->buckets[b].dmat.data();
}
const int32_t* satab_bucket_orders(void* h, int b) {
  return static_cast<Db*>(h)->buckets[b].orders.data();
}
const int32_t* satab_bucket_index(void* h, int b) {
  return static_cast<Db*>(h)->buckets[b].index.data();
}
const char* satab_bucket_names(void* h, int b) {
  return static_cast<Db*>(h)->buckets[b].names.data();
}
int satab_label_size() { return kLabelSize; }
void satab_free(void* h) { delete static_cast<Db*>(h); }

// ---- ASCII emission (native twin of io/writer.py == convdb2.py
// :214-226: header '%6s %4d', lower-triangle 2-char codes at 3-char
// stride, lower-triangle '%6.3f ' distances, diagonals carrying SSE
// types) --------------------------------------------------------------
char* satab_format_entry(const char* name, int order,
                         const int8_t* tabhi, const int8_t* tablo,
                         const int8_t* types, const float* dmat) {
  static const char kHi[] = {'P', 'R', 'O', 'L', '?'};
  static const char kLo[] = {'E', 'D', 'S', 'T', '?'};
  static const char* kType[] = {"e ", "xa", "xi", "xg"};
  const int n = order;
  std::string out;
  out.reserve(static_cast<size_t>(16 + n * n * 5 + 4 * n));
  char buf[64];
  // header '%6s %4d', padded by CHARACTER count like Python's
  // '{:>6s}' (printf %6s pads by BYTES, which diverges for multibyte
  // UTF-8 names); arbitrarily long names emit in full
  size_t nchars = 0;
  for (const char* q = name; *q; ++q) {
    if ((static_cast<unsigned char>(*q) & 0xC0) != 0x80) ++nchars;
  }
  for (size_t k = nchars; k < 6; ++k) out += ' ';
  out += name;
  std::snprintf(buf, sizeof(buf), " %4d\n", n);
  out += buf;
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j <= i; ++j) {
      if (i == j) {
        int t = types[i];
        if (t < 0 || t > 3) return nullptr;
        out += kType[t];
        out += ' ';
      } else {
        int hi = tabhi[i * n + j], lo = tablo[i * n + j];
        if (hi < 0 || hi > 4 || lo < 0 || lo > 4) return nullptr;
        out += kHi[hi];
        out += kLo[lo];
        out += ' ';
      }
    }
    out += '\n';
  }
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j <= i; ++j) {
      double d = (i == j) ? static_cast<double>(types[i])
                          : static_cast<double>(dmat[i * n + j]);
      std::snprintf(buf, sizeof(buf), "%6.3f ", d);
      out += buf;
    }
    out += '\n';
  }
  char* ret = static_cast<char*>(std::malloc(out.size() + 1));
  if (!ret) return nullptr;
  std::memcpy(ret, out.c_str(), out.size() + 1);
  return ret;
}

void satab_free_text(char* p) { std::free(p); }

// ---- score statistics (native twin of gumbelstats.c:50-94) ----------
static const double kEulerGamma = 0.5772156649015328606;
static const double kPiOverSqrt6 = 1.2825498301618640955;

void satab_score_stats(const int32_t* scores, const int32_t* orders,
                       int64_t n, int qn, double a, double b, int compat,
                       double* norm2_out, double* z_out, double* p_out) {
  const double mu = a + b * kEulerGamma;
  const double sigma = kPiOverSqrt6 * b;
  for (int64_t i = 0; i < n; ++i) {
    double n2 = 2.0 * scores[i] / (static_cast<double>(qn) + orders[i]);
    double x = compat ? std::trunc(n2) : n2;
    double z = (x - mu) / sigma;
    norm2_out[i] = n2;
    z_out[i] = z;
    p_out[i] = 1.0 - std::exp(-std::exp(-(kPiOverSqrt6 * z + kEulerGamma)));
  }
}

}  // extern "C"
