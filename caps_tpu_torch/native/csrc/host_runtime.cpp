// Native host runtime for caps_tpu_torch: the ingest hot paths.
//
// The port's own copy of caps_tpu/native/csrc/host_runtime.cpp.  The
// host-side hot loops of ingest — string dictionary encoding, Python
// sequence -> typed column conversion, and the counting sort that lays
// out a relationship table's CSR — live here as a CPython extension,
// compiled with g++ on first use by caps_tpu_torch/native/__init__.py.
// Its callers are caps_tpu_torch/backends/cuda/pool.py (NativeStringPool),
// caps_tpu_torch/backends/cuda/column.py (make_column) and
// caps_tpu_torch/ops/expand.py (build_csr); each keeps its pure-Python
// or numpy twin, which runs only when the caller opts out
// (CAPS_TPU_NO_NATIVE=1), and the tests hold the two bit for bit.
//
// Exposed module: _caps_torch_host
//   pool_new() -> handle            pool_free(handle)
//   pool_size(handle) -> int
//   pool_encode_many(handle, seq[str|None]) -> bytes (int32 codes, -1=null)
//   pool_encode_ucs4(handle, buffer, n, width) -> bytes (int32 codes)
//       # a numpy '<U{width}' array's raw buffer: n fixed-width UCS-4
//       # strings, trailing NULs stripped as numpy does
//   pool_encode1(handle, str) -> int
//   pool_get(handle, code) -> str
//   pool_get_all(handle) -> list[str]
//   pool_get_range(handle, lo, hi) -> list[str]   # codes lo..hi-1
//   pool_truncate(handle, n)        # forget every code >= n (rollback)
//   pool_rank(handle) -> bytes (int32 rank per code, sorted-string order)
//   ingest_i64(seq) -> (bytes data, bytes valid)   # int64 + uint8 mask
//   ingest_f64(seq) -> (bytes data, bytes valid)
//   ingest_bool(seq) -> (bytes data, bytes valid)  # uint8 + uint8 mask
//   csr_build(src: bytes, n_edges, n_nodes)
//       -> (offsets: bytes int64[n_nodes+1], perm: bytes int64[n_edges])
//          # edge permutation grouping edges by source (counting sort)

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Pool {
  std::vector<std::string> strings;
  std::unordered_map<std::string, int32_t> codes;
};

std::mutex g_pools_mu;
std::vector<Pool*> g_pools;

Pool* get_pool(int64_t h) {
  std::lock_guard<std::mutex> lock(g_pools_mu);
  if (h < 0 || h >= (int64_t)g_pools.size() || g_pools[h] == nullptr)
    return nullptr;
  return g_pools[h];
}

int32_t pool_encode(Pool* p, const char* s, Py_ssize_t len) {
  std::string key(s, (size_t)len);
  auto it = p->codes.find(key);
  if (it != p->codes.end()) return it->second;
  int32_t code = (int32_t)p->strings.size();
  p->codes.emplace(std::move(key), code);
  p->strings.emplace_back(s, (size_t)len);
  return code;
}

PyObject* py_pool_new(PyObject*, PyObject*) {
  std::lock_guard<std::mutex> lock(g_pools_mu);
  g_pools.push_back(new Pool());
  return PyLong_FromLongLong((long long)g_pools.size() - 1);
}

PyObject* py_pool_free(PyObject*, PyObject* args) {
  long long h;
  if (!PyArg_ParseTuple(args, "L", &h)) return nullptr;
  std::lock_guard<std::mutex> lock(g_pools_mu);
  if (h >= 0 && h < (long long)g_pools.size() && g_pools[h]) {
    delete g_pools[h];
    g_pools[h] = nullptr;
  }
  Py_RETURN_NONE;
}

PyObject* py_pool_size(PyObject*, PyObject* args) {
  long long h;
  if (!PyArg_ParseTuple(args, "L", &h)) return nullptr;
  Pool* p = get_pool(h);
  if (!p) { PyErr_SetString(PyExc_ValueError, "bad pool handle"); return nullptr; }
  return PyLong_FromSsize_t((Py_ssize_t)p->strings.size());
}

PyObject* py_pool_encode1(PyObject*, PyObject* args) {
  long long h;
  PyObject* obj;
  if (!PyArg_ParseTuple(args, "LO", &h, &obj)) return nullptr;
  Pool* p = get_pool(h);
  if (!p) { PyErr_SetString(PyExc_ValueError, "bad pool handle"); return nullptr; }
  if (obj == Py_None) return PyLong_FromLong(-1);
  Py_ssize_t len;
  const char* s = PyUnicode_AsUTF8AndSize(obj, &len);
  if (!s) return nullptr;
  return PyLong_FromLong(pool_encode(p, s, len));
}

PyObject* py_pool_encode_many(PyObject*, PyObject* args) {
  long long h;
  PyObject* seq;
  if (!PyArg_ParseTuple(args, "LO", &h, &seq)) return nullptr;
  Pool* p = get_pool(h);
  if (!p) { PyErr_SetString(PyExc_ValueError, "bad pool handle"); return nullptr; }
  PyObject* fast = PySequence_Fast(seq, "expected a sequence");
  if (!fast) return nullptr;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
  PyObject* out = PyBytes_FromStringAndSize(nullptr, n * 4);
  if (!out) { Py_DECREF(fast); return nullptr; }
  int32_t* codes = (int32_t*)PyBytes_AS_STRING(out);
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* item = PySequence_Fast_GET_ITEM(fast, i);
    if (item == Py_None) { codes[i] = -1; continue; }
    Py_ssize_t len;
    const char* s = PyUnicode_AsUTF8AndSize(item, &len);
    if (!s) { Py_DECREF(fast); Py_DECREF(out); return nullptr; }
    codes[i] = pool_encode(p, s, len);
  }
  Py_DECREF(fast);
  return out;
}

PyObject* py_pool_get(PyObject*, PyObject* args) {
  long long h, code;
  if (!PyArg_ParseTuple(args, "LL", &h, &code)) return nullptr;
  Pool* p = get_pool(h);
  if (!p) { PyErr_SetString(PyExc_ValueError, "bad pool handle"); return nullptr; }
  if (code < 0) Py_RETURN_NONE;
  if (code >= (long long)p->strings.size()) {
    PyErr_SetString(PyExc_IndexError, "code out of range");
    return nullptr;
  }
  const std::string& s = p->strings[code];
  return PyUnicode_FromStringAndSize(s.data(), (Py_ssize_t)s.size());
}

PyObject* py_pool_get_all(PyObject*, PyObject* args) {
  long long h;
  if (!PyArg_ParseTuple(args, "L", &h)) return nullptr;
  Pool* p = get_pool(h);
  if (!p) { PyErr_SetString(PyExc_ValueError, "bad pool handle"); return nullptr; }
  PyObject* out = PyList_New((Py_ssize_t)p->strings.size());
  if (!out) return nullptr;
  for (size_t i = 0; i < p->strings.size(); ++i) {
    PyObject* s = PyUnicode_FromStringAndSize(p->strings[i].data(),
                                              (Py_ssize_t)p->strings[i].size());
    if (!s) { Py_DECREF(out); return nullptr; }
    PyList_SET_ITEM(out, (Py_ssize_t)i, s);
  }
  return out;
}

PyObject* py_pool_get_range(PyObject*, PyObject* args) {
  long long h, lo, hi;
  if (!PyArg_ParseTuple(args, "LLL", &h, &lo, &hi)) return nullptr;
  Pool* p = get_pool(h);
  if (!p) { PyErr_SetString(PyExc_ValueError, "bad pool handle"); return nullptr; }
  if (lo < 0 || hi < lo || hi > (long long)p->strings.size()) {
    PyErr_SetString(PyExc_IndexError, "code range out of range");
    return nullptr;
  }
  PyObject* out = PyList_New((Py_ssize_t)(hi - lo));
  if (!out) return nullptr;
  for (long long i = lo; i < hi; ++i) {
    const std::string& s = p->strings[(size_t)i];
    PyObject* o = PyUnicode_FromStringAndSize(s.data(), (Py_ssize_t)s.size());
    if (!o) { Py_DECREF(out); return nullptr; }
    PyList_SET_ITEM(out, (Py_ssize_t)(i - lo), o);
  }
  return out;
}

PyObject* py_pool_truncate(PyObject*, PyObject* args) {
  long long h, n;
  if (!PyArg_ParseTuple(args, "LL", &h, &n)) return nullptr;
  Pool* p = get_pool(h);
  if (!p) { PyErr_SetString(PyExc_ValueError, "bad pool handle"); return nullptr; }
  if (n < 0) n = 0;
  while ((long long)p->strings.size() > n) {
    p->codes.erase(p->strings.back());
    p->strings.pop_back();
  }
  Py_RETURN_NONE;
}

// One UCS-4 code point -> UTF-8; false for a value no str can hold
// encoded (a surrogate or beyond U+10FFFF).
bool append_utf8(std::string* out, uint32_t c) {
  if (c < 0x80) {
    out->push_back((char)c);
  } else if (c < 0x800) {
    out->push_back((char)(0xC0 | (c >> 6)));
    out->push_back((char)(0x80 | (c & 0x3F)));
  } else if (c < 0x10000) {
    if (c >= 0xD800 && c <= 0xDFFF) return false;
    out->push_back((char)(0xE0 | (c >> 12)));
    out->push_back((char)(0x80 | ((c >> 6) & 0x3F)));
    out->push_back((char)(0x80 | (c & 0x3F)));
  } else if (c <= 0x10FFFF) {
    out->push_back((char)(0xF0 | (c >> 18)));
    out->push_back((char)(0x80 | ((c >> 12) & 0x3F)));
    out->push_back((char)(0x80 | ((c >> 6) & 0x3F)));
    out->push_back((char)(0x80 | (c & 0x3F)));
  } else {
    return false;
  }
  return true;
}

PyObject* py_pool_encode_ucs4(PyObject*, PyObject* args) {
  long long h, n, width;
  Py_buffer buf;
  if (!PyArg_ParseTuple(args, "Ly*LL", &h, &buf, &n, &width)) return nullptr;
  Pool* p = get_pool(h);
  if (!p || n < 0 || width < 0 || buf.len < (Py_ssize_t)(n * width * 4)) {
    PyBuffer_Release(&buf);
    PyErr_SetString(PyExc_ValueError,
                    p ? "buffer too small for n x width" : "bad pool handle");
    return nullptr;
  }
  PyObject* out = PyBytes_FromStringAndSize(nullptr, (Py_ssize_t)(n * 4));
  if (!out) { PyBuffer_Release(&buf); return nullptr; }
  int32_t* codes = (int32_t*)PyBytes_AS_STRING(out);
  const uint32_t* chars = (const uint32_t*)buf.buf;
  std::string s;
  for (long long i = 0; i < n; ++i) {
    const uint32_t* row = chars + i * width;
    long long len = width;
    while (len > 0 && row[len - 1] == 0) --len;  // numpy strips trailing NULs
    s.clear();
    for (long long j = 0; j < len; ++j) {
      if (!append_utf8(&s, row[j])) {
        Py_DECREF(out);
        PyBuffer_Release(&buf);
        PyErr_SetString(PyExc_ValueError,
                        "string holds a code point UTF-8 cannot encode");
        return nullptr;
      }
    }
    codes[i] = pool_encode(p, s.data(), (Py_ssize_t)s.size());
  }
  PyBuffer_Release(&buf);
  return out;
}

PyObject* py_pool_rank(PyObject*, PyObject* args) {
  long long h;
  if (!PyArg_ParseTuple(args, "L", &h)) return nullptr;
  Pool* p = get_pool(h);
  if (!p) { PyErr_SetString(PyExc_ValueError, "bad pool handle"); return nullptr; }
  size_t n = p->strings.size();
  std::vector<int32_t> order(n);
  for (size_t i = 0; i < n; ++i) order[i] = (int32_t)i;
  std::stable_sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    return p->strings[a] < p->strings[b];
  });
  PyObject* out = PyBytes_FromStringAndSize(nullptr, (Py_ssize_t)(n * 4));
  if (!out) return nullptr;
  int32_t* rank = (int32_t*)PyBytes_AS_STRING(out);
  for (size_t i = 0; i < n; ++i) rank[order[i]] = (int32_t)i;
  return out;
}

// ---- typed ingest ---------------------------------------------------------

template <typename T, typename Conv>
PyObject* ingest(PyObject* seq, Conv conv) {
  PyObject* fast = PySequence_Fast(seq, "expected a sequence");
  if (!fast) return nullptr;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
  PyObject* data = PyBytes_FromStringAndSize(nullptr, n * (Py_ssize_t)sizeof(T));
  PyObject* valid = PyBytes_FromStringAndSize(nullptr, n);
  if (!data || !valid) {
    Py_XDECREF(data); Py_XDECREF(valid); Py_DECREF(fast);
    return nullptr;
  }
  T* d = (T*)PyBytes_AS_STRING(data);
  uint8_t* v = (uint8_t*)PyBytes_AS_STRING(valid);
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* item = PySequence_Fast_GET_ITEM(fast, i);
    if (item == Py_None) { d[i] = (T)0; v[i] = 0; continue; }
    if (!conv(item, &d[i])) {
      Py_DECREF(fast); Py_DECREF(data); Py_DECREF(valid);
      return nullptr;
    }
    v[i] = 1;
  }
  Py_DECREF(fast);
  PyObject* tup = PyTuple_Pack(2, data, valid);
  Py_DECREF(data); Py_DECREF(valid);
  return tup;
}

PyObject* py_ingest_i64(PyObject*, PyObject* args) {
  PyObject* seq;
  if (!PyArg_ParseTuple(args, "O", &seq)) return nullptr;
  return ingest<int64_t>(seq, [](PyObject* o, int64_t* out) {
    long long x = PyLong_AsLongLong(o);
    if (x == -1 && PyErr_Occurred()) {
      if (PyFloat_Check(o)) {  // tolerate float-valued ints like the Python path
        double d = PyFloat_AS_DOUBLE(o);
        // match int(v): NaN/inf and doubles beyond int64 range raise
        // (casting them is UB in C++ and would store garbage marked valid)
        if (!(d >= -9223372036854775808.0 && d < 9223372036854775808.0)) {
          return false;  // leaves the PyLong_AsLongLong error set
        }
        PyErr_Clear();
        *out = (int64_t)d;
        return true;
      }
      return false;
    }
    *out = (int64_t)x;
    return true;
  });
}

PyObject* py_ingest_f64(PyObject*, PyObject* args) {
  PyObject* seq;
  if (!PyArg_ParseTuple(args, "O", &seq)) return nullptr;
  return ingest<double>(seq, [](PyObject* o, double* out) {
    double x = PyFloat_AsDouble(o);
    if (x == -1.0 && PyErr_Occurred()) return false;
    *out = x;
    return true;
  });
}

PyObject* py_ingest_bool(PyObject*, PyObject* args) {
  PyObject* seq;
  if (!PyArg_ParseTuple(args, "O", &seq)) return nullptr;
  return ingest<uint8_t>(seq, [](PyObject* o, uint8_t* out) {
    int x = PyObject_IsTrue(o);
    if (x < 0) return false;
    *out = (uint8_t)x;
    return true;
  });
}

// ---- CSR construction -----------------------------------------------------

PyObject* py_csr_build(PyObject*, PyObject* args) {
  Py_buffer src_buf;
  long long n_edges, n_nodes;
  if (!PyArg_ParseTuple(args, "y*LL", &src_buf, &n_edges, &n_nodes))
    return nullptr;
  const int64_t* src = (const int64_t*)src_buf.buf;
  if (src_buf.len < (Py_ssize_t)(n_edges * 8)) {
    PyBuffer_Release(&src_buf);
    PyErr_SetString(PyExc_ValueError, "buffer too small");
    return nullptr;
  }
  PyObject* offsets = PyBytes_FromStringAndSize(nullptr, (n_nodes + 1) * 8);
  PyObject* perm = PyBytes_FromStringAndSize(nullptr, n_edges * 8);
  if (!offsets || !perm) {
    Py_XDECREF(offsets); Py_XDECREF(perm);
    PyBuffer_Release(&src_buf);
    return nullptr;
  }
  int64_t* off = (int64_t*)PyBytes_AS_STRING(offsets);
  int64_t* pm = (int64_t*)PyBytes_AS_STRING(perm);
  std::memset(off, 0, (size_t)(n_nodes + 1) * 8);
  for (long long e = 0; e < n_edges; ++e) {
    int64_t s = src[e];
    if (s < 0 || s >= n_nodes) {
      Py_DECREF(offsets); Py_DECREF(perm);
      PyBuffer_Release(&src_buf);
      PyErr_SetString(PyExc_ValueError, "source id out of range");
      return nullptr;
    }
    off[s + 1]++;
  }
  for (long long i = 0; i < n_nodes; ++i) off[i + 1] += off[i];
  std::vector<int64_t> cursor(off, off + n_nodes);
  for (long long e = 0; e < n_edges; ++e) pm[cursor[src[e]]++] = e;
  PyBuffer_Release(&src_buf);
  PyObject* tup = PyTuple_Pack(2, offsets, perm);
  Py_DECREF(offsets); Py_DECREF(perm);
  return tup;
}

PyMethodDef methods[] = {
    {"pool_new", py_pool_new, METH_NOARGS, "new string pool -> handle"},
    {"pool_free", py_pool_free, METH_VARARGS, "free pool"},
    {"pool_size", py_pool_size, METH_VARARGS, "pool size"},
    {"pool_encode1", py_pool_encode1, METH_VARARGS, "encode one string"},
    {"pool_encode_many", py_pool_encode_many, METH_VARARGS,
     "encode a sequence -> int32 bytes"},
    {"pool_get", py_pool_get, METH_VARARGS, "decode one code"},
    {"pool_get_all", py_pool_get_all, METH_VARARGS, "all pool strings"},
    {"pool_get_range", py_pool_get_range, METH_VARARGS,
     "pool strings of codes lo..hi-1"},
    {"pool_truncate", py_pool_truncate, METH_VARARGS,
     "forget every code >= n"},
    {"pool_encode_ucs4", py_pool_encode_ucs4, METH_VARARGS,
     "encode a fixed-width UCS-4 buffer -> int32 bytes"},
    {"pool_rank", py_pool_rank, METH_VARARGS, "sorted rank per code"},
    {"ingest_i64", py_ingest_i64, METH_VARARGS, "list -> int64 col"},
    {"ingest_f64", py_ingest_f64, METH_VARARGS, "list -> float64 col"},
    {"ingest_bool", py_ingest_bool, METH_VARARGS, "list -> bool col"},
    {"csr_build", py_csr_build, METH_VARARGS,
     "source ids -> CSR offsets + edge permutation"},
    {nullptr, nullptr, 0, nullptr}};

struct PyModuleDef module_def = {PyModuleDef_HEAD_INIT, "_caps_torch_host",
                                 "caps_tpu_torch native host runtime", -1,
                                 methods};

}  // namespace

PyMODINIT_FUNC PyInit__caps_torch_host(void) {
  return PyModule_Create(&module_def);
}
