// Copied unchanged from native/wirecodec.cc of the repository (the reference
// package's wire codec); only this header is new.  Built by
// riak_ensemble_tpu_torch/ops/build.py (load_wire) with g++ as a CPython
// extension under riak_ensemble_tpu_torch/build/.

// Native wire codec for the restricted TCP frame format.
//
// The reference ships terms over disterl, whose term codec is C inside
// the BEAM (decode constructs plain terms only, never code).  This
// module is that native codec for our transport: the same tag/varint
// format as riak_ensemble_tpu/wire.py, byte-exact on encode so native
// and Python frames are interchangeable on the wire, with the same
// allowlist property — decode builds values exclusively from plain
// containers and the registered protocol record types.
//
// Built as a CPython extension (no pybind11 in the image); wire.py
// loads it lazily and keeps the pure-Python implementation as both
// fallback and differential-test oracle.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kMaxDepth = 32;  // matches wire._MAX_DEPTH

// Registered by wire.py at import: the record registry (class,
// field-name tuple) in code order, the NOTFOUND sentinel, and the
// WireError exception class.
PyObject *g_wire_error = nullptr;
PyObject *g_notfound = nullptr;
struct Record {
  PyObject *cls;     // strong ref
  PyObject *fields;  // strong ref, tuple of str
};
std::vector<Record> g_records;

int set_wire_error(const char *msg) {
  PyErr_SetString(g_wire_error ? g_wire_error : PyExc_ValueError, msg);
  return -1;
}

// ---------------------------------------------------------------- encode

struct Buf {
  std::string s;
  void put(char c) { s.push_back(c); }
  void put(const char *p, size_t n) { s.append(p, n); }
};

void put_uvarint(Buf &b, uint64_t n) {
  for (;;) {
    uint8_t x = n & 0x7F;
    n >>= 7;
    if (n) {
      b.put(static_cast<char>(x | 0x80));
    } else {
      b.put(static_cast<char>(x));
      return;
    }
  }
}

int encode_value(Buf &b, PyObject *v, int depth);

// Python's encoding: nbytes = (bit_length + 8) // 8 (min 1), then
// to_bytes(nbytes, "big", signed=True).  For a value that fits in
// long long we reproduce those bytes directly.
int encode_small_int(Buf &b, long long ll) {
  uint64_t mag = ll < 0 ? static_cast<uint64_t>(-(ll + 1)) + 1
                        : static_cast<uint64_t>(ll);
  int bl = 0;
  for (uint64_t m = mag; m; m >>= 1) ++bl;
  int n = (bl + 8) / 8;
  if (n < 1) n = 1;
  b.put('i');
  put_uvarint(b, static_cast<uint64_t>(n));
  for (int i = n - 1; i >= 0; --i) {
    int shift = 8 * i;
    uint8_t byte = shift < 64
        ? static_cast<uint8_t>(static_cast<uint64_t>(ll) >> shift)
        : (ll < 0 ? 0xFF : 0x00);
    b.put(static_cast<char>(byte));
  }
  return 0;
}

int encode_big_int(Buf &b, PyObject *v) {
  PyObject *bl_obj = PyObject_CallMethod(v, "bit_length", nullptr);
  if (!bl_obj) return -1;
  long long bl = PyLong_AsLongLong(bl_obj);
  Py_DECREF(bl_obj);
  if (bl < 0 && PyErr_Occurred()) return -1;
  long long n = (bl + 8) / 8;
  if (n < 1) n = 1;
  PyObject *raw = PyObject_CallMethod(
      v, "to_bytes", "(Ls)", n, "big");
  if (!raw) {
    // needs signed=True for negatives — retry with kwargs
    PyErr_Clear();
    PyObject *meth = PyObject_GetAttrString(v, "to_bytes");
    if (!meth) return -1;
    PyObject *args = Py_BuildValue("(Ls)", n, "big");
    PyObject *kw = Py_BuildValue("{s:O}", "signed", Py_True);
    raw = (args && kw) ? PyObject_Call(meth, args, kw) : nullptr;
    Py_XDECREF(args);
    Py_XDECREF(kw);
    Py_DECREF(meth);
    if (!raw) return -1;
  }
  char *p;
  Py_ssize_t len;
  if (PyBytes_AsStringAndSize(raw, &p, &len) < 0) {
    Py_DECREF(raw);
    return -1;
  }
  b.put('i');
  put_uvarint(b, static_cast<uint64_t>(len));
  b.put(p, static_cast<size_t>(len));
  Py_DECREF(raw);
  return 0;
}

// Always call to_bytes with signed=True (matches wire.py exactly,
// including for positives where the extra headroom byte appears).
int encode_int(Buf &b, PyObject *v) {
  int overflow = 0;
  long long ll = PyLong_AsLongLongAndOverflow(v, &overflow);
  if (!overflow && !(ll == -1 && PyErr_Occurred()))
    return encode_small_int(b, ll);
  PyErr_Clear();
  return encode_big_int(b, v);
}

int encode_float(Buf &b, PyObject *v) {
  double d = PyFloat_AS_DOUBLE(v);
  uint64_t bits;
  std::memcpy(&bits, &d, 8);
  b.put('f');
  for (int i = 7; i >= 0; --i)
    b.put(static_cast<char>(bits >> (8 * i)));
  return 0;
}

int encode_container(Buf &b, PyObject *v, char tag, int depth) {
  b.put(tag);
  Py_ssize_t n = PyObject_Size(v);
  if (n < 0) return -1;
  put_uvarint(b, static_cast<uint64_t>(n));
  PyObject *it = PyObject_GetIter(v);
  if (!it) return -1;
  PyObject *item;
  while ((item = PyIter_Next(it)) != nullptr) {
    int rc = encode_value(b, item, depth + 1);
    Py_DECREF(item);
    if (rc < 0) {
      Py_DECREF(it);
      return -1;
    }
  }
  Py_DECREF(it);
  return PyErr_Occurred() ? -1 : 0;
}

int encode_value(Buf &b, PyObject *v, int depth) {
  if (depth > kMaxDepth)
    return set_wire_error("value too deeply nested");
  if (v == Py_None) {
    b.put('N');
    return 0;
  }
  if (v == g_notfound) {
    b.put('0');
    return 0;
  }
  PyTypeObject *t = Py_TYPE(v);
  if (t == &PyBool_Type) {
    b.put(v == Py_True ? 'T' : 'F');
    return 0;
  }
  if (t == &PyLong_Type) return encode_int(b, v);
  if (t == &PyFloat_Type) return encode_float(b, v);
  if (t == &PyUnicode_Type) {
    Py_ssize_t len;
    const char *p = PyUnicode_AsUTF8AndSize(v, &len);
    if (!p) return -1;
    b.put('s');
    put_uvarint(b, static_cast<uint64_t>(len));
    b.put(p, static_cast<size_t>(len));
    return 0;
  }
  if (t == &PyBytes_Type) {
    char *p;
    Py_ssize_t len;
    if (PyBytes_AsStringAndSize(v, &p, &len) < 0) return -1;
    b.put('b');
    put_uvarint(b, static_cast<uint64_t>(len));
    b.put(p, static_cast<size_t>(len));
    return 0;
  }
  if (t == &PyTuple_Type) return encode_container(b, v, 't', depth);
  if (t == &PyList_Type) return encode_container(b, v, 'l', depth);
  if (t == &PySet_Type) return encode_container(b, v, 'e', depth);
  if (t == &PyFrozenSet_Type) return encode_container(b, v, 'z', depth);
  if (t == &PyDict_Type) {
    b.put('d');
    put_uvarint(b, static_cast<uint64_t>(PyDict_Size(v)));
    PyObject *key, *val;
    Py_ssize_t pos = 0;
    while (PyDict_Next(v, &pos, &key, &val)) {
      if (encode_value(b, key, depth + 1) < 0) return -1;
      if (encode_value(b, val, depth + 1) < 0) return -1;
    }
    return 0;
  }
  for (size_t code = 0; code < g_records.size(); ++code) {
    if (reinterpret_cast<PyObject *>(t) != g_records[code].cls) continue;
    b.put('R');
    put_uvarint(b, static_cast<uint64_t>(code));
    PyObject *fields = g_records[code].fields;
    Py_ssize_t nf = PyTuple_GET_SIZE(fields);
    for (Py_ssize_t i = 0; i < nf; ++i) {
      PyObject *fv = PyObject_GetAttr(v, PyTuple_GET_ITEM(fields, i));
      if (!fv) return -1;
      int rc = encode_value(b, fv, depth + 1);
      Py_DECREF(fv);
      if (rc < 0) return -1;
    }
    return 0;
  }
  PyErr_Format(g_wire_error ? g_wire_error : PyExc_ValueError,
               "type %s is not wire-encodable", t->tp_name);
  return -1;
}

// ---------------------------------------------------------------- decode

struct Reader {
  const uint8_t *buf;
  size_t len;
  size_t pos;

  int take(size_t n, const uint8_t **out) {
    if (n > len - pos) return set_wire_error("truncated frame");
    *out = buf + pos;
    pos += n;
    return 0;
  }

  int uvarint(uint64_t *out) {
    int shift = 0;
    uint64_t n = 0;
    for (;;) {
      const uint8_t *p;
      if (take(1, &p) < 0) return -1;
      // Bits shifted past 63 must be an error, not a silent wrap:
      // Python's unbounded int keeps the huge value and then fails
      // downstream, so wrapping here would make the two decoders
      // disagree on hostile frames (cross-node decode divergence).
      if (shift == 63 && (*p & 0x7F) > 1)
        return set_wire_error("varint too long");
      n |= static_cast<uint64_t>(*p & 0x7F) << shift;
      if (!(*p & 0x80)) {
        *out = n;
        return 0;
      }
      shift += 7;
      if (shift > 63) return set_wire_error("varint too long");
    }
  }
};

// Raw-frame context: the resolved memoryview slices a 'B' frame's
// buffer table describes (wire.py's raw-buffer section).  Slices are
// built once in py_decode and borrowed by 'r' tag resolution; they
// keep the input payload alive through the master memoryview.
struct RawCtx {
  std::vector<PyObject *> slices;  // strong refs, released by caller
};

PyObject *decode_value(Reader &r, int depth, RawCtx *ctx);

PyObject *decode_int(const uint8_t *p, size_t n) {
  if (n == 0) return PyLong_FromLong(0);  // matches int.from_bytes(b"")
  if (n <= 8) {
    // Accumulate unsigned (left-shifting a negative int64 is UB
    // before C++20; this decoder compiles as C++17) and bit-cast to
    // signed at the end — the sign-extension prefix makes the final
    // pattern the two's-complement value.
    uint64_t acc = (p[0] & 0x80) ? ~uint64_t{0} : 0;
    for (size_t i = 0; i < n; ++i)
      acc = (acc << 8) | static_cast<uint64_t>(p[i]);
    int64_t val;
    static_assert(sizeof(val) == sizeof(acc), "bit-cast width");
    memcpy(&val, &acc, sizeof(val));
    return PyLong_FromLongLong(val);
  }
  PyObject *raw = PyBytes_FromStringAndSize(
      reinterpret_cast<const char *>(p), static_cast<Py_ssize_t>(n));
  if (!raw) return nullptr;
  PyObject *meth = PyObject_GetAttrString(
      reinterpret_cast<PyObject *>(&PyLong_Type), "from_bytes");
  PyObject *args = meth ? Py_BuildValue("(Os)", raw, "big") : nullptr;
  PyObject *kw = args ? Py_BuildValue("{s:O}", "signed", Py_True) : nullptr;
  PyObject *out = kw ? PyObject_Call(meth, args, kw) : nullptr;
  Py_XDECREF(kw);
  Py_XDECREF(args);
  Py_XDECREF(meth);
  Py_DECREF(raw);
  return out;
}

// Count-prefixed element sequence.  The count is hostile input: never
// preallocated — each element consumes >= 1 byte, so growth is
// bounded by the payload.
int decode_items(Reader &r, int depth, uint64_t n,
                 std::vector<PyObject *> *items, RawCtx *ctx) {
  items->reserve(n < 4096 ? n : 4096);
  for (uint64_t i = 0; i < n; ++i) {
    PyObject *item = decode_value(r, depth + 1, ctx);
    if (!item) {
      for (PyObject *o : *items) Py_DECREF(o);
      items->clear();
      return -1;
    }
    items->push_back(item);
  }
  return 0;
}

PyObject *wrap_unhashable(const char *what) {
  // matches wire.py: unhashable members are a malformed frame
  PyObject *type, *value, *tb;
  PyErr_Fetch(&type, &value, &tb);
  PyObject *msg = value ? PyObject_Str(value) : nullptr;
  PyErr_Format(g_wire_error, "unhashable %s: %s", what,
               msg ? PyUnicode_AsUTF8(msg) : "TypeError");
  Py_XDECREF(msg);
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  return nullptr;
}

PyObject *decode_value(Reader &r, int depth, RawCtx *ctx) {
  if (depth > kMaxDepth) {
    set_wire_error("frame too deep");
    return nullptr;
  }
  const uint8_t *tp;
  if (r.take(1, &tp) < 0) return nullptr;
  uint8_t tag = *tp;
  switch (tag) {
    case 'r': {
      uint64_t idx;
      if (r.uvarint(&idx) < 0) return nullptr;
      if (!ctx || idx >= ctx->slices.size()) {
        PyErr_Format(g_wire_error,
                     "buffer ref %llu outside raw frame",
                     static_cast<unsigned long long>(idx));
        return nullptr;
      }
      PyObject *mv = ctx->slices[static_cast<size_t>(idx)];
      Py_INCREF(mv);
      return mv;
    }
    case 'N':
      Py_RETURN_NONE;
    case 'T':
      Py_RETURN_TRUE;
    case 'F':
      Py_RETURN_FALSE;
    case '0':
      Py_INCREF(g_notfound);
      return g_notfound;
    case 'i': {
      uint64_t n;
      const uint8_t *p;
      if (r.uvarint(&n) < 0 || r.take(n, &p) < 0) return nullptr;
      return decode_int(p, n);
    }
    case 'f': {
      const uint8_t *p;
      if (r.take(8, &p) < 0) return nullptr;
      uint64_t bits = 0;
      for (int i = 0; i < 8; ++i) bits = (bits << 8) | p[i];
      double d;
      std::memcpy(&d, &bits, 8);
      return PyFloat_FromDouble(d);
    }
    case 's': {
      uint64_t n;
      const uint8_t *p;
      if (r.uvarint(&n) < 0 || r.take(n, &p) < 0) return nullptr;
      PyObject *out = PyUnicode_DecodeUTF8(
          reinterpret_cast<const char *>(p),
          static_cast<Py_ssize_t>(n), nullptr);
      if (!out && PyErr_ExceptionMatches(PyExc_UnicodeDecodeError)) {
        PyErr_Clear();
        set_wire_error("bad utf-8 in frame");
      }
      return out;
    }
    case 'b': {
      uint64_t n;
      const uint8_t *p;
      if (r.uvarint(&n) < 0 || r.take(n, &p) < 0) return nullptr;
      return PyBytes_FromStringAndSize(
          reinterpret_cast<const char *>(p), static_cast<Py_ssize_t>(n));
    }
    case 't':
    case 'l':
    case 'e':
    case 'z': {
      uint64_t n;
      if (r.uvarint(&n) < 0) return nullptr;
      std::vector<PyObject *> items;
      if (decode_items(r, depth, n, &items, ctx) < 0) return nullptr;
      if (tag == 't') {
        PyObject *out = PyTuple_New(static_cast<Py_ssize_t>(items.size()));
        if (!out) {
          for (PyObject *o : items) Py_DECREF(o);
          return nullptr;
        }
        for (size_t i = 0; i < items.size(); ++i)
          PyTuple_SET_ITEM(out, static_cast<Py_ssize_t>(i), items[i]);
        return out;
      }
      if (tag == 'l') {
        PyObject *out = PyList_New(static_cast<Py_ssize_t>(items.size()));
        if (!out) {
          for (PyObject *o : items) Py_DECREF(o);
          return nullptr;
        }
        for (size_t i = 0; i < items.size(); ++i)
          PyList_SET_ITEM(out, static_cast<Py_ssize_t>(i), items[i]);
        return out;
      }
      PyObject *out = tag == 'e' ? PySet_New(nullptr)
                                 : PyFrozenSet_New(nullptr);
      if (!out) {
        for (PyObject *o : items) Py_DECREF(o);
        return nullptr;
      }
      for (size_t i = 0; i < items.size(); ++i) {
        int rc = PySet_Add(out, items[i]);
        Py_DECREF(items[i]);
        if (rc < 0) {
          for (size_t j = i + 1; j < items.size(); ++j)
            Py_DECREF(items[j]);
          Py_DECREF(out);
          if (PyErr_ExceptionMatches(PyExc_TypeError))
            return wrap_unhashable("set member");
          return nullptr;
        }
      }
      return out;
    }
    case 'd': {
      uint64_t n;
      if (r.uvarint(&n) < 0) return nullptr;
      PyObject *out = PyDict_New();
      if (!out) return nullptr;
      for (uint64_t i = 0; i < n; ++i) {
        PyObject *key = decode_value(r, depth + 1, ctx);
        if (!key) {
          Py_DECREF(out);
          return nullptr;
        }
        PyObject *val = decode_value(r, depth + 1, ctx);
        if (!val) {
          Py_DECREF(key);
          Py_DECREF(out);
          return nullptr;
        }
        int rc = PyDict_SetItem(out, key, val);
        Py_DECREF(key);
        Py_DECREF(val);
        if (rc < 0) {
          Py_DECREF(out);
          if (PyErr_ExceptionMatches(PyExc_TypeError))
            return wrap_unhashable("dict key");
          return nullptr;
        }
      }
      return out;
    }
    case 'R': {
      uint64_t code;
      if (r.uvarint(&code) < 0) return nullptr;
      if (code >= g_records.size()) {
        PyErr_Format(g_wire_error, "unknown record code %llu",
                     static_cast<unsigned long long>(code));
        return nullptr;
      }
      PyObject *fields = g_records[code].fields;
      Py_ssize_t nf = PyTuple_GET_SIZE(fields);
      PyObject *kw = PyDict_New();
      if (!kw) return nullptr;
      for (Py_ssize_t i = 0; i < nf; ++i) {
        PyObject *val = decode_value(r, depth + 1, ctx);
        if (!val) {
          Py_DECREF(kw);
          return nullptr;
        }
        int rc = PyDict_SetItem(kw, PyTuple_GET_ITEM(fields, i), val);
        Py_DECREF(val);
        if (rc < 0) {
          Py_DECREF(kw);
          return nullptr;
        }
      }
      PyObject *empty = PyTuple_New(0);
      PyObject *out = empty
          ? PyObject_Call(g_records[code].cls, empty, kw) : nullptr;
      Py_XDECREF(empty);
      Py_DECREF(kw);
      return out;
    }
    default:
      PyErr_Format(g_wire_error, "unknown tag b'%c'",
                   tag >= 0x20 && tag < 0x7F ? tag : '?');
      return nullptr;
  }
}

// ---------------------------------------------------------------- module

PyObject *py_register(PyObject *, PyObject *args) {
  PyObject *records, *notfound, *wire_error;
  if (!PyArg_ParseTuple(args, "OOO", &records, &notfound, &wire_error))
    return nullptr;
  for (Record &rec : g_records) {
    Py_DECREF(rec.cls);
    Py_DECREF(rec.fields);
  }
  g_records.clear();
  Py_ssize_t n = PySequence_Size(records);
  if (n < 0) return nullptr;
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject *pair = PySequence_GetItem(records, i);
    if (!pair) return nullptr;
    PyObject *cls = PySequence_GetItem(pair, 0);
    PyObject *fields = PySequence_GetItem(pair, 1);
    Py_DECREF(pair);
    if (!cls || !fields || !PyTuple_Check(fields)) {
      Py_XDECREF(cls);
      Py_XDECREF(fields);
      PyErr_SetString(PyExc_TypeError,
                      "records must be [(cls, (field, ...)), ...]");
      return nullptr;
    }
    g_records.push_back(Record{cls, fields});
  }
  Py_XDECREF(g_notfound);
  Py_INCREF(notfound);
  g_notfound = notfound;
  Py_XDECREF(g_wire_error);
  Py_INCREF(wire_error);
  g_wire_error = wire_error;
  Py_RETURN_NONE;
}

PyObject *py_encode(PyObject *, PyObject *v) {
  if (!g_wire_error) {
    PyErr_SetString(PyExc_RuntimeError, "wire codec not registered");
    return nullptr;
  }
  Buf b;
  b.s.reserve(256);
  if (encode_value(b, v, 0) < 0) return nullptr;
  return PyBytes_FromStringAndSize(b.s.data(),
                                   static_cast<Py_ssize_t>(b.s.size()));
}

// Decode a 'B'-tagged raw frame (wire.py's raw-buffer section):
// buffer-length table, term section, then the raw bytes — resolved as
// memoryview slices of the input object (zero-copy; the slices hold
// the payload alive through the master memoryview).
PyObject *decode_raw_frame(PyObject *arg, const uint8_t *buf,
                           size_t len) {
  Reader tr{buf, len, 1};  // past the 'B' tag
  uint64_t nbufs;
  if (tr.uvarint(&nbufs) < 0) return nullptr;
  std::vector<uint64_t> lens;
  uint64_t total = 0;
  for (uint64_t i = 0; i < nbufs; ++i) {
    uint64_t n;
    if (tr.uvarint(&n) < 0) return nullptr;
    if (n > len || total + n > len) {
      set_wire_error("raw-buffer table exceeds frame");
      return nullptr;
    }
    lens.push_back(n);
    total += n;
  }
  size_t data_start = len - static_cast<size_t>(total);
  if (data_start < tr.pos) {
    set_wire_error("raw-buffer table exceeds frame");
    return nullptr;
  }
  PyObject *master = PyMemoryView_FromObject(arg);
  if (!master) return nullptr;
  RawCtx ctx;
  int ok = 0;
  size_t off = data_start;
  for (uint64_t n : lens) {
    PyObject *lo = PyLong_FromSize_t(off);
    PyObject *hi = PyLong_FromSize_t(off + static_cast<size_t>(n));
    PyObject *slice = (lo && hi) ? PySlice_New(lo, hi, nullptr)
                                 : nullptr;
    Py_XDECREF(lo);
    Py_XDECREF(hi);
    PyObject *mv = slice ? PyObject_GetItem(master, slice) : nullptr;
    Py_XDECREF(slice);
    if (!mv) {
      ok = -1;
      break;
    }
    ctx.slices.push_back(mv);
    off += static_cast<size_t>(n);
  }
  PyObject *out = nullptr;
  if (ok == 0) {
    Reader r{buf, data_start, tr.pos};
    out = decode_value(r, 0, &ctx);
    if (out && r.pos != data_start) {
      Py_DECREF(out);
      out = nullptr;
      set_wire_error("trailing bytes in frame");
    }
  }
  for (PyObject *mv : ctx.slices) Py_DECREF(mv);
  Py_DECREF(master);
  return out;
}

PyObject *py_decode(PyObject *, PyObject *arg) {
  if (!g_wire_error) {
    PyErr_SetString(PyExc_RuntimeError, "wire codec not registered");
    return nullptr;
  }
  Py_buffer view;
  if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) < 0) return nullptr;
  const uint8_t *buf = static_cast<const uint8_t *>(view.buf);
  size_t len = static_cast<size_t>(view.len);
  PyObject *out;
  if (len > 0 && buf[0] == 'B') {
    out = decode_raw_frame(arg, buf, len);
  } else {
    Reader r{buf, len, 0};
    out = decode_value(r, 0, nullptr);
    if (out && r.pos != r.len) {
      Py_DECREF(out);
      out = nullptr;
      set_wire_error("trailing bytes in frame");
    }
  }
  PyBuffer_Release(&view);
  return out;
}

PyMethodDef kMethods[] = {
    {"register", py_register, METH_VARARGS,
     "register(records, notfound, wire_error)"},
    {"encode", py_encode, METH_O, "encode(value) -> bytes"},
    {"decode", py_decode, METH_O, "decode(bytes) -> value"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef kModule = {
    PyModuleDef_HEAD_INIT, "_retpu_wire",
    "Native restricted wire codec (see native/wirecodec.cc)", -1,
    kMethods, nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__retpu_wire(void) {
  return PyModule_Create(&kModule);
}
