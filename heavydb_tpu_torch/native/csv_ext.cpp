// Native delimited-file parser — the role of the reference's parallel
// chunked CSV import (ImportExport/Importer.cpp delimited parse: worker
// threads over byte ranges, TypedImportBuffer columns).  Exposed as a
// CPython extension; heavydb_tpu_torch.io falls back to pandas when the
// toolchain is unavailable.
//
// Two-pass design:
//   1. index: find row starts (quote-aware), split the file into
//      per-thread byte ranges aligned to row boundaries;
//   2. parse: each thread classifies+converts its rows into typed
//      columns (int64 / float64 / string), with per-cell null flags.
// Column types are unified across threads (any string → string; any
// float → float).  Returns, per column:
//   ("i", int64 bytes, null bytes) | ("f", float64 bytes, null bytes) |
//   ("s", payload bytes, int64 offset bytes)  — offsets len = rows+1,
//   null string cells encode as offset[i]==offset[i+1] with null flag
//   folded into a separate bytes object.
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <atomic>
#include <cctype>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct ColChunk {
  // per-thread, per-column accumulation
  std::vector<int64_t> ints;
  std::vector<double> floats;
  std::vector<std::string> strs;
  std::vector<uint8_t> nulls;
  int kind = 0;  // 0 = all-null/unknown, 1 = int, 2 = float, 3 = string
};

bool parse_int(const char* s, size_t n, int64_t* out) {
  if (n == 0 || n > 19) return false;
  size_t i = 0;
  bool neg = false;
  if (s[0] == '-' || s[0] == '+') {
    neg = s[0] == '-';
    i = 1;
    if (i == n) return false;
  }
  int64_t v = 0;
  for (; i < n; ++i) {
    if (s[i] < '0' || s[i] > '9') return false;
    v = v * 10 + (s[i] - '0');
  }
  *out = neg ? -v : v;
  return true;
}

bool parse_float(const char* s, size_t n, double* out) {
  if (n == 0 || n > 64) return false;
  char buf[65];
  std::memcpy(buf, s, n);
  buf[n] = 0;
  char* end = nullptr;
  double v = std::strtod(buf, &end);
  if (end != buf + n) return false;
  *out = v;
  return true;
}

// textual null markers (pandas na_values parity with the python
// fallback's _NULL_TOKENS) — recognized HERE so a numeric column with
// "NULL" cells classifies numeric natively instead of stringifying
bool is_null_token(const char* s, size_t n) {
  switch (n) {
    case 0:
      return true;
    case 2:
      return s[0] == '\\' && s[1] == 'N';
    case 4:
      return (memcmp(s, "NULL", 4) == 0) || (memcmp(s, "null", 4) == 0);
    default:
      return false;
  }
}

// split one row into fields (quote-aware, in-place views)
void split_row(const char* p, const char* end, char delim,
               std::vector<std::pair<const char*, size_t>>& fields) {
  fields.clear();
  const char* f = p;
  bool in_q = false;
  for (const char* c = p; c <= end; ++c) {
    if (c == end || (*c == delim && !in_q)) {
      fields.emplace_back(f, (size_t)(c - f));
      f = c + 1;
      if (c == end) break;
    } else if (*c == '"') {
      in_q = !in_q;
    }
  }
}

void unquote(const char*& s, size_t& n) {
  if (n >= 2 && s[0] == '"' && s[n - 1] == '"') {
    s += 1;
    n -= 2;
  }
}

// materialize a (possibly quoted) field value, collapsing "" escapes
std::string field_str(const char* s, size_t n) {
  if (memchr(s, '"', n) == nullptr) return std::string(s, n);
  std::string out;
  out.reserve(n);
  for (size_t i = 0; i < n; ++i) {
    out.push_back(s[i]);
    if (s[i] == '"' && i + 1 < n && s[i + 1] == '"') ++i;
  }
  return out;
}

struct ParseResult {
  std::vector<ColChunk> cols;
  size_t rows = 0;
};

void parse_range(const char* base, size_t begin, size_t end_off, char delim,
                 size_t ncols, ParseResult* out) {
  out->cols.resize(ncols);
  std::vector<std::pair<const char*, size_t>> fields;
  const char* p = base + begin;
  const char* stop = base + end_off;
  while (p < stop) {
    const char* nl = (const char*)memchr(p, '\n', (size_t)(stop - p));
    const char* row_end = nl ? nl : stop;
    const char* trimmed = row_end;
    if (trimmed > p && trimmed[-1] == '\r') --trimmed;
    if (trimmed > p) {
      split_row(p, trimmed, delim, fields);
      ++out->rows;
      for (size_t c = 0; c < ncols; ++c) {
        ColChunk& col = out->cols[c];
        const char* fs = c < fields.size() ? fields[c].first : "";
        size_t fn = c < fields.size() ? fields[c].second : 0;
        unquote(fs, fn);
        bool is_null = is_null_token(fs, fn);
        int64_t iv;
        double dv;
        int cell_kind;
        if (is_null) {
          cell_kind = 0;
        } else if (parse_int(fs, fn, &iv)) {
          cell_kind = 1;
        } else if (parse_float(fs, fn, &dv)) {
          cell_kind = 2;
        } else {
          cell_kind = 3;
        }
        if (cell_kind > col.kind) {
          // widen history: unknown → ints → floats → strings
          size_t nprev = col.nulls.size();
          if (cell_kind == 3) {
            std::vector<std::string> ss;
            ss.reserve(nprev);
            char tmp2[32];
            for (size_t i = 0; i < nprev; ++i) {
              if (!col.nulls[i]) {
                ss.emplace_back();
              } else if (col.kind == 1) {
                snprintf(tmp2, sizeof tmp2, "%lld",
                         (long long)col.ints[i]);
                ss.emplace_back(tmp2);
              } else if (col.kind == 2) {
                snprintf(tmp2, sizeof tmp2, "%g", col.floats[i]);
                ss.emplace_back(tmp2);
              } else {
                ss.emplace_back();
              }
            }
            col.strs = std::move(ss);
            col.ints.clear();
            col.floats.clear();
          } else if (cell_kind == 2) {
            if (col.kind == 1) {
              col.floats.reserve(nprev);
              for (int64_t x : col.ints) col.floats.push_back((double)x);
              col.ints.clear();
            } else {  // unknown → float: backfill null placeholders
              col.floats.assign(nprev, 0.0);
            }
          } else {  // unknown → int: backfill null placeholders
            col.ints.assign(nprev, 0);
          }
          col.kind = cell_kind;
        }
        col.nulls.push_back(is_null ? 0 : 1);
        switch (col.kind) {
          case 0:
            break;
          case 1:
            col.ints.push_back(is_null ? 0 : iv);
            break;
          case 2:
            col.floats.push_back(
                is_null ? 0.0 : (cell_kind == 1 ? (double)iv : dv));
            break;
          case 3:
            col.strs.emplace_back(is_null ? std::string()
                                          : field_str(fs, fn));
            break;
        }
      }
    }
    if (!nl) break;
    p = nl + 1;
  }
}

PyObject* py_parse_csv(PyObject*, PyObject* args) {
  const char* data;
  Py_ssize_t len;
  int delim_ch;
  int has_header;
  int nthreads;
  if (!PyArg_ParseTuple(args, "y#iii", &data, &len, &delim_ch, &has_header,
                        &nthreads)) {
    return nullptr;
  }
  char delim = (char)delim_ch;
  // header row → column count + names
  const char* first_nl = (const char*)memchr(data, '\n', (size_t)len);
  size_t header_end = first_nl ? (size_t)(first_nl - data) : (size_t)len;
  std::vector<std::pair<const char*, size_t>> hdr;
  {
    const char* he = data + header_end;
    if (he > data && he[-1] == '\r') --he;
    split_row(data, he, delim, hdr);
  }
  size_t ncols = hdr.size();
  size_t body_begin = has_header && first_nl
                          ? (size_t)(first_nl - data) + 1
                          : 0;

  // carve thread ranges at row boundaries
  int T = nthreads > 0 ? nthreads
                       : (int)std::thread::hardware_concurrency();
  if (T < 1) T = 1;
  if ((size_t)len - body_begin < (size_t)(1 << 20)) T = 1;
  std::vector<size_t> starts{body_begin};
  for (int t = 1; t < T; ++t) {
    size_t guess = body_begin + ((size_t)len - body_begin) * t / T;
    const char* nl =
        (const char*)memchr(data + guess, '\n', (size_t)len - guess);
    size_t s = nl ? (size_t)(nl - data) + 1 : (size_t)len;
    if (s > starts.back()) starts.push_back(s);
  }
  starts.push_back((size_t)len);

  std::vector<ParseResult> results(starts.size() - 1);
  {
    Py_BEGIN_ALLOW_THREADS;
    std::vector<std::thread> threads;
    for (size_t t = 0; t + 1 < starts.size(); ++t) {
      threads.emplace_back(parse_range, data, starts[t], starts[t + 1],
                           delim, ncols, &results[t]);
    }
    for (auto& th : threads) th.join();
    Py_END_ALLOW_THREADS;
  }

  // unify per-column kinds across threads
  std::vector<int> kinds(ncols, 0);
  size_t total_rows = 0;
  for (auto& r : results) total_rows += r.rows;
  for (size_t c = 0; c < ncols; ++c) {
    for (auto& r : results) kinds[c] = std::max(kinds[c], r.cols[c].kind);
    if (kinds[c] == 0) kinds[c] = 1;  // all-null → int column of nulls
  }

  PyObject* names = PyList_New((Py_ssize_t)ncols);
  for (size_t c = 0; c < ncols; ++c) {
    const char* hs = c < hdr.size() ? hdr[c].first : "";
    size_t hn = c < hdr.size() ? hdr[c].second : 0;
    unquote(hs, hn);
    PyList_SET_ITEM(names, (Py_ssize_t)c,
                    PyUnicode_FromStringAndSize(hs, (Py_ssize_t)hn));
  }

  PyObject* cols_out = PyList_New((Py_ssize_t)ncols);
  char tmp[32];
  for (size_t c = 0; c < ncols; ++c) {
    PyObject* entry = nullptr;
    if (kinds[c] == 3) {
      std::string payload;
      std::vector<int64_t> offs{0};
      std::string nulls;
      for (auto& r : results) {
        ColChunk& col = r.cols[c];
        for (size_t i = 0; i < r.rows; ++i) {
          uint8_t present = i < col.nulls.size() ? col.nulls[i] : 0;
          nulls.push_back((char)present);
          if (col.kind == 3) {
            const std::string& s =
                i < col.strs.size() ? col.strs[i] : std::string();
            payload += s;
          } else if (present && col.kind == 1) {
            snprintf(tmp, sizeof tmp, "%lld", (long long)col.ints[i]);
            payload += tmp;
          } else if (present && col.kind == 2) {
            snprintf(tmp, sizeof tmp, "%g", col.floats[i]);
            payload += tmp;
          }
          offs.push_back((int64_t)payload.size());
        }
      }
      entry = Py_BuildValue(
          "(sy#y#y#)", "s", payload.data(), (Py_ssize_t)payload.size(),
          (const char*)offs.data(),
          (Py_ssize_t)(offs.size() * sizeof(int64_t)), nulls.data(),
          (Py_ssize_t)nulls.size());
    } else if (kinds[c] == 2) {
      std::vector<double> vals;
      std::string nulls;
      vals.reserve(total_rows);
      for (auto& r : results) {
        ColChunk& col = r.cols[c];
        for (size_t i = 0; i < r.rows; ++i) {
          uint8_t present = i < col.nulls.size() ? col.nulls[i] : 0;
          nulls.push_back((char)present);
          double v = 0.0;
          if (present) {
            v = col.kind == 1 ? (double)col.ints[i]
                              : (i < col.floats.size() ? col.floats[i] : 0.0);
          }
          vals.push_back(v);
        }
      }
      entry = Py_BuildValue(
          "(sy#y#)", "f", (const char*)vals.data(),
          (Py_ssize_t)(vals.size() * sizeof(double)), nulls.data(),
          (Py_ssize_t)nulls.size());
    } else {
      std::vector<int64_t> vals;
      std::string nulls;
      vals.reserve(total_rows);
      for (auto& r : results) {
        ColChunk& col = r.cols[c];
        for (size_t i = 0; i < r.rows; ++i) {
          uint8_t present = i < col.nulls.size() ? col.nulls[i] : 0;
          nulls.push_back((char)present);
          vals.push_back(present && i < col.ints.size() ? col.ints[i] : 0);
        }
      }
      entry = Py_BuildValue(
          "(sy#y#)", "i", (const char*)vals.data(),
          (Py_ssize_t)(vals.size() * sizeof(int64_t)), nulls.data(),
          (Py_ssize_t)nulls.size());
    }
    if (!entry) {
      Py_DECREF(names);
      Py_DECREF(cols_out);
      return nullptr;
    }
    PyList_SET_ITEM(cols_out, (Py_ssize_t)c, entry);
  }
  return Py_BuildValue("(NNn)", names, cols_out, (Py_ssize_t)total_rows);
}

PyMethodDef methods[] = {
    {"parse_csv", py_parse_csv, METH_VARARGS,
     "parse_csv(bytes, delim_ord, has_header, nthreads) -> (names, cols, "
     "nrows)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_csv_ext", nullptr, -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__csv_ext(void) { return PyModule_Create(&moduledef); }
