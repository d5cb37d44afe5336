// The port's own copy of cldrd_tpu/native/tsvparse.cpp (same source; built by
// cldrd_tpu_torch/native/__init__.py into build/native/).
//
// Native TSV corpus parser.
//
// The host-side replacement for the reference's per-line Python parsing of
// the 8.8M-row MS MARCO collection (reference dataset/utils.py:4-29 and the
// parse loops inside every NwayDataset.create_from_* constructor,
// dataset/nway_dataset.py:213-467). That parse is on the critical path of
// the <15-min full-index budget: the corpus must be parsed and tokenized
// fast enough to overlap the TPU encode stream.
//
// Design: one mmap'd pass over the file; line/tab boundaries found with
// memchr (vectorized by libc); ids parsed with a tight inline
// ASCII-to-int64; Python objects constructed once per row via the CPython
// C API (no intermediate Python-level split/strip allocations).
//
// Exports:
//   parse_id_text_tsv(path, allow_title=False) -> dict[int, str | dict]
//     2-column rows -> {id: text}
//     3-column rows (allow_title) -> {id: {"title": t, "para": p}}
//   count_lines(path) -> int
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cerrno>
#include <cstring>

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

// Parse a decimal (optionally negative) int64 from [p, end); returns false
// on empty/invalid input.
inline bool parse_i64(const char* p, const char* end, long long* out) {
    if (p == end) return false;
    bool neg = false;
    if (*p == '-') {
        neg = true;
        ++p;
        if (p == end) return false;
    }
    long long v = 0;
    for (; p != end; ++p) {
        unsigned c = static_cast<unsigned>(*p) - '0';
        if (c > 9) return false;
        v = v * 10 + static_cast<long long>(c);
    }
    *out = neg ? -v : v;
    return true;
}

// Strip ASCII whitespace from both ends (Python str.strip() parity for the
// text column).
inline void strip(const char** b, const char** e) {
    const char* p = *b;
    const char* q = *e;
    while (p < q && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n')) ++p;
    while (q > p && (q[-1] == ' ' || q[-1] == '\t' || q[-1] == '\r' || q[-1] == '\n')) --q;
    *b = p;
    *e = q;
}

PyObject* parse_id_text_tsv(PyObject*, PyObject* args, PyObject* kwargs) {
    const char* path = nullptr;
    int allow_title = 0;
    static const char* kwlist[] = {"path", "allow_title", nullptr};
    if (!PyArg_ParseTupleAndKeywords(args, kwargs, "s|p",
                                     const_cast<char**>(kwlist), &path,
                                     &allow_title)) {
        return nullptr;
    }

    MappedFile mf;
    if (!mf.open_file(path)) {
        PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
        return nullptr;
    }

    PyObject* result = PyDict_New();
    if (result == nullptr) return nullptr;

    PyObject* title_key = PyUnicode_InternFromString("title");
    PyObject* para_key = PyUnicode_InternFromString("para");

    const char* p = mf.data;
    const char* file_end = mf.data + mf.size;
    long long line_no = 0;
    while (p < file_end) {
        const char* nl = static_cast<const char*>(
            memchr(p, '\n', static_cast<size_t>(file_end - p)));
        const char* line_end = nl ? nl : file_end;
        ++line_no;

        // skip blank lines (including trailing newline at EOF)
        const char* lb = p;
        const char* le = line_end;
        if (le > lb && le[-1] == '\r') --le;
        if (le > lb) {
            const char* tab1 = static_cast<const char*>(
                memchr(lb, '\t', static_cast<size_t>(le - lb)));
            if (tab1 == nullptr) {
                PyErr_Format(PyExc_ValueError,
                             "%s:%lld: no tab separator", path, line_no);
                goto fail;
            }
            long long id_val;
            if (!parse_i64(lb, tab1, &id_val)) {
                PyErr_Format(PyExc_ValueError,
                             "%s:%lld: bad integer id", path, line_no);
                goto fail;
            }
            PyObject* key = PyLong_FromLongLong(id_val);
            if (key == nullptr) goto fail;

            const char* rest = tab1 + 1;
            const char* tab2 =
                allow_title ? static_cast<const char*>(memchr(
                                  rest, '\t', static_cast<size_t>(le - rest)))
                            : nullptr;
            PyObject* value = nullptr;
            if (tab2 == nullptr) {
                const char* tb = rest;
                const char* te = le;
                strip(&tb, &te);
                value = PyUnicode_DecodeUTF8(tb, te - tb, "replace");
            } else {
                PyObject* title = PyUnicode_DecodeUTF8(
                    rest, tab2 - rest, "replace");
                PyObject* para = PyUnicode_DecodeUTF8(
                    tab2 + 1, le - (tab2 + 1), "replace");
                if (title != nullptr && para != nullptr) {
                    value = PyDict_New();
                    if (value != nullptr &&
                        (PyDict_SetItem(value, title_key, title) != 0 ||
                         PyDict_SetItem(value, para_key, para) != 0)) {
                        Py_CLEAR(value);
                    }
                }
                Py_XDECREF(title);
                Py_XDECREF(para);
            }
            if (value == nullptr) {
                Py_DECREF(key);
                goto fail;
            }
            int rc = PyDict_SetItem(result, key, value);
            Py_DECREF(key);
            Py_DECREF(value);
            if (rc != 0) goto fail;
        }
        p = nl ? nl + 1 : file_end;
    }
    Py_XDECREF(title_key);
    Py_XDECREF(para_key);
    return result;

fail:
    Py_XDECREF(title_key);
    Py_XDECREF(para_key);
    Py_DECREF(result);
    return nullptr;
}

PyObject* count_lines(PyObject*, PyObject* args) {
    const char* path = nullptr;
    if (!PyArg_ParseTuple(args, "s", &path)) return nullptr;
    MappedFile mf;
    if (!mf.open_file(path)) {
        PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
        return nullptr;
    }
    long long n = 0;
    const char* p = mf.data;
    const char* end = mf.data + mf.size;
    while (p < end) {
        const char* nl = static_cast<const char*>(
            memchr(p, '\n', static_cast<size_t>(end - p)));
        ++n;
        p = nl ? nl + 1 : end;
    }
    return PyLong_FromLongLong(n);
}

PyMethodDef methods[] = {
    {"parse_id_text_tsv", reinterpret_cast<PyCFunction>(parse_id_text_tsv),
     METH_VARARGS | METH_KEYWORDS,
     "parse_id_text_tsv(path, allow_title=False) -> dict[int, str|dict]"},
    {"count_lines", count_lines, METH_VARARGS, "count_lines(path) -> int"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_tsvparse",
    "mmap-based TSV corpus parser (CPython C API)", -1, methods,
    nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__tsvparse(void) { return PyModule_Create(&moduledef); }
