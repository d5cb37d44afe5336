// The port's own copy of cldrd_tpu/native/jsonlparse.cpp (same source; built by
// cldrd_tpu_torch/native/__init__.py into build/native/).
//
// Native JSONL training-file parser.
//
// The host-side replacement for per-line json.loads over the teacher
// ranking files (reference dataset/nway_dataset.py:213-467 parses
// 5relT_25neg/10relT_20neg/20relT_10neg/30relT JSON(L) with ujson — a C
// library; SURVEY §2.1). A 500k-query curriculum stage re-parses at every
// iteration, so the parse sits on the train-startup path next to the TSV
// corpus parse.
//
// Scope: FLAT JSON objects, one per line, with values limited to what the
// training schema uses — integers, floats, strings (simple escapes), and
// homogeneous arrays of numbers or strings. Anything outside that (nested
// objects, \u escapes, bool/null) raises ValueError and the Python caller
// falls back to json.loads for the whole file, so correctness never
// depends on this fast path.
//
// Design mirrors tsvparse.cpp: one mmap'd sequential pass, memchr line
// scanning, a tight recursive-descent value parser building CPython
// objects directly (no intermediate Python strings per token).
//
// Exports:
//   parse_jsonl(path) -> list[dict]
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cerrno>
#include <cstdlib>
#include <cstring>
#include <string>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct MappedFile {
    const char* data = nullptr;
    size_t size = 0;
    int fd = -1;

    bool open_file(const char* path) {
        fd = ::open(path, O_RDONLY);
        if (fd < 0) return false;
        struct stat st;
        if (fstat(fd, &st) != 0) return false;
        size = static_cast<size_t>(st.st_size);
        if (size == 0) {
            data = nullptr;
            return true;
        }
        void* p = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
        if (p == MAP_FAILED) return false;
        madvise(p, size, MADV_SEQUENTIAL);
        data = static_cast<const char*>(p);
        return true;
    }

    ~MappedFile() {
        if (data != nullptr) munmap(const_cast<char*>(data), size);
        if (fd >= 0) ::close(fd);
    }
};

struct Cursor {
    const char* p;
    const char* end;
    bool failed = false;  // unsupported construct -> caller falls back

    void skip_ws() {
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    }
    bool at(char c) {
        skip_ws();
        return p < end && *p == c;
    }
    bool eat(char c) {
        skip_ws();
        if (p < end && *p == c) {
            ++p;
            return true;
        }
        return false;
    }
};

// Parse a JSON string literal (cursor ON the opening quote). Returns a new
// PyUnicode, or nullptr with cur.failed set for unsupported escapes.
PyObject* parse_string(Cursor& cur) {
    ++cur.p;  // opening quote
    const char* start = cur.p;
    // fast path: no escapes; raw control chars are invalid JSON
    const char* q = start;
    while (q < cur.end && *q != '"' && *q != '\\') {
        if (static_cast<unsigned char>(*q) < 0x20) {
            cur.failed = true;
            return nullptr;
        }
        ++q;
    }
    if (q >= cur.end) {
        cur.failed = true;
        return nullptr;
    }
    if (*q == '"') {
        cur.p = q + 1;
        return PyUnicode_DecodeUTF8(start, q - start, "strict");
    }
    // slow path: build into a buffer handling simple escapes
    std::string buf;
    buf.reserve(64);
    const char* r = start;
    while (r < cur.end && *r != '"') {
        if (static_cast<unsigned char>(*r) < 0x20) {
            cur.failed = true;
            return nullptr;
        }
        if (*r != '\\') {
            buf.push_back(*r++);
            continue;
        }
        if (r + 1 >= cur.end) {
            cur.failed = true;
            return nullptr;
        }
        switch (r[1]) {
            case '"': buf.push_back('"'); break;
            case '\\': buf.push_back('\\'); break;
            case '/': buf.push_back('/'); break;
            case 'n': buf.push_back('\n'); break;
            case 't': buf.push_back('\t'); break;
            case 'r': buf.push_back('\r'); break;
            case 'b': buf.push_back('\b'); break;
            case 'f': buf.push_back('\f'); break;
            default:  // \uXXXX and anything else -> python fallback
                cur.failed = true;
                return nullptr;
        }
        r += 2;
    }
    if (r >= cur.end) {
        cur.failed = true;
        return nullptr;
    }
    cur.p = r + 1;
    return PyUnicode_DecodeUTF8(buf.data(), buf.size(), "strict");
}

// Parse a number; cursor on '-' or digit.
PyObject* parse_number(Cursor& cur) {
    const char* start = cur.p;
    const char* q = start;
    bool is_float = false;
    if (q < cur.end && *q == '-') ++q;
    // integer part: '0' or [1-9][0-9]* (JSON grammar; json.loads rejects 007)
    const char* int_start = q;
    while (q < cur.end && *q >= '0' && *q <= '9') ++q;
    if (q == int_start ||
        (*int_start == '0' && q - int_start > 1)) {
        cur.failed = true;
        return nullptr;
    }
    if (q < cur.end && *q == '.') {
        is_float = true;
        ++q;
        const char* frac = q;
        while (q < cur.end && *q >= '0' && *q <= '9') ++q;
        if (q == frac) {  // '1.' is invalid JSON
            cur.failed = true;
            return nullptr;
        }
    }
    if (q < cur.end && (*q == 'e' || *q == 'E')) {
        is_float = true;
        ++q;
        if (q < cur.end && (*q == '+' || *q == '-')) ++q;
        const char* exp = q;
        while (q < cur.end && *q >= '0' && *q <= '9') ++q;
        if (q == exp) {  // '1e' is invalid JSON
            cur.failed = true;
            return nullptr;
        }
    }
    if (q == start || q - start >= 63) {
        cur.failed = true;
        return nullptr;
    }
    // strtod/strtoll re-scan from their start pointer with NO end bound: on
    // a raw mmap a truncated file ending in a digit at an exact page
    // boundary would read past the mapping. Copy the bounded token into a
    // stack buffer first.
    char buf[64];
    memcpy(buf, start, static_cast<size_t>(q - start));
    buf[q - start] = '\0';
    if (is_float) {
        char* endp = nullptr;
        double v = strtod(buf, &endp);
        if (endp != buf + (q - start)) {
            cur.failed = true;
            return nullptr;
        }
        cur.p = q;
        return PyFloat_FromDouble(v);
    }
    // integer: training pids fit int64; overflow -> fallback
    errno = 0;
    char* endp = nullptr;
    long long v = strtoll(buf, &endp, 10);
    if (endp != buf + (q - start) || errno == ERANGE) {
        cur.failed = true;
        return nullptr;
    }
    cur.p = q;
    return PyLong_FromLongLong(v);
}

PyObject* parse_value(Cursor& cur);  // fwd

PyObject* parse_array(Cursor& cur) {
    ++cur.p;  // '['
    PyObject* list = PyList_New(0);
    if (list == nullptr) return nullptr;
    if (cur.eat(']')) return list;
    for (;;) {
        PyObject* v = parse_value(cur);
        if (v == nullptr) {
            Py_DECREF(list);
            return nullptr;
        }
        int rc = PyList_Append(list, v);
        Py_DECREF(v);
        if (rc != 0) {
            Py_DECREF(list);
            return nullptr;
        }
        if (cur.eat(',')) continue;
        if (cur.eat(']')) return list;
        cur.failed = true;
        Py_DECREF(list);
        return nullptr;
    }
}

PyObject* parse_value(Cursor& cur) {
    cur.skip_ws();
    if (cur.p >= cur.end) {
        cur.failed = true;
        return nullptr;
    }
    char c = *cur.p;
    if (c == '"') return parse_string(cur);
    if (c == '[') return parse_array(cur);
    if (c == '-' || (c >= '0' && c <= '9')) return parse_number(cur);
    // nested objects / true / false / null: out of schema -> fallback
    cur.failed = true;
    return nullptr;
}

// Parse one flat object line into a dict; nullptr + failed on fallback.
PyObject* parse_object(Cursor& cur) {
    if (!cur.eat('{')) {
        cur.failed = true;
        return nullptr;
    }
    PyObject* dict = PyDict_New();
    if (dict == nullptr) return nullptr;
    if (cur.eat('}')) return dict;
    for (;;) {
        if (!cur.at('"')) {
            cur.failed = true;
            Py_DECREF(dict);
            return nullptr;
        }
        PyObject* key = parse_string(cur);
        if (key == nullptr) {
            Py_DECREF(dict);
            return nullptr;
        }
        if (!cur.eat(':')) {
            cur.failed = true;
            Py_XDECREF(key);
            Py_DECREF(dict);
            return nullptr;
        }
        PyObject* val = parse_value(cur);
        if (val == nullptr) {
            Py_DECREF(key);
            Py_DECREF(dict);
            return nullptr;
        }
        int rc = PyDict_SetItem(dict, key, val);
        Py_DECREF(key);
        Py_DECREF(val);
        if (rc != 0) {
            Py_DECREF(dict);
            return nullptr;
        }
        if (cur.eat(',')) continue;
        if (cur.eat('}')) return dict;
        cur.failed = true;
        Py_DECREF(dict);
        return nullptr;
    }
}

PyObject* parse_jsonl(PyObject*, PyObject* args) {
    const char* path = nullptr;
    if (!PyArg_ParseTuple(args, "s", &path)) return nullptr;

    MappedFile mf;
    if (!mf.open_file(path)) {
        PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
        return nullptr;
    }
    PyObject* out = PyList_New(0);
    if (out == nullptr) return nullptr;

    const char* p = mf.data;
    const char* end = mf.data + mf.size;
    while (p != nullptr && p < end) {
        const char* nl = static_cast<const char*>(
            memchr(p, '\n', static_cast<size_t>(end - p)));
        const char* line_end = nl != nullptr ? nl : end;
        const char* q = p;
        while (q < line_end && (*q == ' ' || *q == '\t' || *q == '\r')) ++q;
        if (q >= line_end) {
            // blank line: json.loads('') raises on the Python path, so the
            // native path must not silently skip it (rank-sharded line
            // numbering would diverge) — fall the whole file back
            Py_DECREF(out);
            PyErr_SetString(PyExc_ValueError,
                            "jsonlparse: blank line (fallback)");
            return nullptr;
        }
        {
            Cursor cur{q, line_end};
            PyObject* obj = parse_object(cur);
            if (obj == nullptr) {
                Py_DECREF(out);
                if (cur.failed && !PyErr_Occurred()) {
                    PyErr_Format(
                        PyExc_ValueError,
                        "jsonlparse: construct outside the training-file "
                        "schema near byte %zd of %s (caller falls back to "
                        "json.loads)",
                        static_cast<Py_ssize_t>(cur.p - mf.data), path);
                }
                return nullptr;
            }
            // trailing garbage after the object -> fallback
            cur.skip_ws();
            if (cur.p < line_end) {
                Py_DECREF(obj);
                Py_DECREF(out);
                PyErr_SetString(PyExc_ValueError,
                                "jsonlparse: trailing content on line");
                return nullptr;
            }
            int rc = PyList_Append(out, obj);
            Py_DECREF(obj);
            if (rc != 0) {
                Py_DECREF(out);
                return nullptr;
            }
        }
        if (nl == nullptr) break;
        p = nl + 1;
    }
    return out;
}

PyMethodDef methods[] = {
    {"parse_jsonl", parse_jsonl, METH_VARARGS,
     "parse_jsonl(path) -> list[dict] (flat training-schema JSONL)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_jsonlparse",
    "Native flat-JSONL training-file parser", -1, methods,
    nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__jsonlparse(void) { return PyModule_Create(&moduledef); }
