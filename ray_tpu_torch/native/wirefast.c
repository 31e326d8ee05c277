/* _rtpu_wirefast — C decode path for the ray_tpu typed wire codec.
 *
 * Mirrors ray_tpu/core/wire.py _decode_value exactly (same tags, same
 * bounds: 16M container cap, depth 100, trailing-byte check, struct ids
 * resolved through a Python callback into the same registry). The pure
 * Python decoder remains the semantics reference and the fallback when
 * no compiler is present; tests run both.
 *
 * The hot frames are TaskSpec pushes (~40 primitive leaves per spec) and
 * task_done payloads — decoding them here instead of bytecode is a
 * ~5-10x win on the head-throughput envelope (docs/PERF_NOTES.md r5).
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

#define T_NONE 0
#define T_TRUE 1
#define T_FALSE 2
#define T_INT 3
#define T_BIGINT 4
#define T_FLOAT 5
#define T_STR 6
#define T_BYTES 7
#define T_LIST 8
#define T_TUPLE 9
#define T_DICT 10
#define T_SET 11
#define T_STRUCT 12
#define T_FROZENSET 13

#define MAX_CONTAINER (1 << 24)
#define MAX_DEPTH 100

static PyObject *g_decode_err = NULL; /* WireDecodeError */
static PyObject *g_struct_cb = NULL;  /* (sid:int, vals:tuple) -> object */

typedef struct {
    const unsigned char *p;
    const unsigned char *end;
} Reader;

static void raise_err(const char *msg)
{
    if (!PyErr_Occurred())
        PyErr_SetString(g_decode_err ? g_decode_err : PyExc_ValueError, msg);
}

static int need(Reader *r, Py_ssize_t n)
{
    if (r->end - r->p < n) {
        raise_err("truncated frame");
        return 0;
    }
    return 1;
}

static uint32_t rd_u32(Reader *r)
{
    uint32_t v;
    memcpy(&v, r->p, 4);
    r->p += 4;
    return v;
}

static PyObject *decode_value(Reader *r, int depth)
{
    if (depth > MAX_DEPTH) {
        raise_err("frame nesting too deep");
        return NULL;
    }
    if (!need(r, 1))
        return NULL;
    unsigned char tag = *r->p++;
    switch (tag) {
    case T_NONE:
        Py_RETURN_NONE;
    case T_TRUE:
        Py_RETURN_TRUE;
    case T_FALSE:
        Py_RETURN_FALSE;
    case T_INT: {
        if (!need(r, 8))
            return NULL;
        int64_t v;
        memcpy(&v, r->p, 8);
        r->p += 8;
        return PyLong_FromLongLong((long long)v);
    }
    case T_BIGINT: {
        if (!need(r, 4))
            return NULL;
        uint32_t n = rd_u32(r);
        if (!need(r, (Py_ssize_t)n))
            return NULL;
        PyObject *v = _PyLong_FromByteArray(r->p, n, 1 /*little*/, 1 /*signed*/);
        r->p += n;
        return v;
    }
    case T_FLOAT: {
        if (!need(r, 8))
            return NULL;
        double d;
        memcpy(&d, r->p, 8);
        r->p += 8;
        return PyFloat_FromDouble(d);
    }
    case T_STR: {
        if (!need(r, 4))
            return NULL;
        uint32_t n = rd_u32(r);
        if (!need(r, (Py_ssize_t)n))
            return NULL;
        PyObject *s = PyUnicode_DecodeUTF8((const char *)r->p, n, NULL);
        if (s == NULL) {
            PyErr_Clear();
            raise_err("invalid utf-8 in frame");
            return NULL;
        }
        r->p += n;
        return s;
    }
    case T_BYTES: {
        if (!need(r, 4))
            return NULL;
        uint32_t n = rd_u32(r);
        if (!need(r, (Py_ssize_t)n))
            return NULL;
        PyObject *b = PyBytes_FromStringAndSize((const char *)r->p, n);
        r->p += n;
        return b;
    }
    case T_LIST:
    case T_TUPLE:
    case T_SET:
    case T_FROZENSET: {
        if (!need(r, 4))
            return NULL;
        uint32_t n = rd_u32(r);
        if (n > MAX_CONTAINER) {
            raise_err("container too large");
            return NULL;
        }
        if (tag == T_LIST || tag == T_TUPLE) {
            PyObject *out = (tag == T_LIST) ? PyList_New(n) : PyTuple_New(n);
            if (out == NULL)
                return NULL;
            for (uint32_t i = 0; i < n; i++) {
                PyObject *item = decode_value(r, depth + 1);
                if (item == NULL) {
                    Py_DECREF(out);
                    return NULL;
                }
                if (tag == T_LIST)
                    PyList_SET_ITEM(out, i, item);
                else
                    PyTuple_SET_ITEM(out, i, item);
            }
            return out;
        }
        PyObject *out = (tag == T_SET) ? PySet_New(NULL)
                                       : PyFrozenSet_New(NULL);
        if (out == NULL)
            return NULL;
        for (uint32_t i = 0; i < n; i++) {
            PyObject *item = decode_value(r, depth + 1);
            if (item == NULL || PySet_Add(out, item) < 0) {
                Py_XDECREF(item);
                Py_DECREF(out);
                return NULL;
            }
            Py_DECREF(item);
        }
        return out;
    }
    case T_DICT: {
        if (!need(r, 4))
            return NULL;
        uint32_t n = rd_u32(r);
        if (n > MAX_CONTAINER) {
            raise_err("container too large");
            return NULL;
        }
        PyObject *out = PyDict_New();
        if (out == NULL)
            return NULL;
        for (uint32_t i = 0; i < n; i++) {
            PyObject *k = decode_value(r, depth + 1);
            if (k == NULL) {
                Py_DECREF(out);
                return NULL;
            }
            PyObject *v = decode_value(r, depth + 1);
            if (v == NULL || PyDict_SetItem(out, k, v) < 0) {
                Py_DECREF(k);
                Py_XDECREF(v);
                Py_DECREF(out);
                return NULL;
            }
            Py_DECREF(k);
            Py_DECREF(v);
        }
        return out;
    }
    case T_STRUCT: {
        if (!need(r, 2))
            return NULL;
        uint16_t sid;
        memcpy(&sid, r->p, 2);
        r->p += 2;
        PyObject *vals = decode_value(r, depth + 1);
        if (vals == NULL)
            return NULL;
        if (!PyTuple_Check(vals)) {
            Py_DECREF(vals);
            raise_err("struct fields must be a tuple");
            return NULL;
        }
        /* the callback owns registry lookup + error wrapping */
        PyObject *out = PyObject_CallFunction(g_struct_cb, "iO", (int)sid,
                                              vals);
        Py_DECREF(vals);
        return out;
    }
    default:
        raise_err("unknown tag");
        return NULL;
    }
}

static PyObject *py_decode(PyObject *self, PyObject *arg)
{
    Py_buffer view;
    if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) < 0)
        return NULL;
    Reader r;
    r.p = (const unsigned char *)view.buf;
    r.end = r.p + view.len;
    if (view.len < 3 || r.p[0] != 'R' || r.p[1] != 'W') {
        PyBuffer_Release(&view);
        raise_err("bad magic: not a ray_tpu control frame");
        return NULL;
    }
    if (r.p[2] != 1) {
        PyBuffer_Release(&view);
        raise_err("unsupported wire version");
        return NULL;
    }
    r.p += 3;
    PyObject *out = decode_value(&r, 0);
    if (out != NULL && r.p != r.end) {
        Py_DECREF(out);
        out = NULL;
        raise_err("trailing bytes after frame");
    }
    PyBuffer_Release(&view);
    return out;
}

static PyObject *py_init(PyObject *self, PyObject *args)
{
    PyObject *err, *cb;
    if (!PyArg_ParseTuple(args, "OO", &err, &cb))
        return NULL;
    Py_XINCREF(err);
    Py_XSETREF(g_decode_err, err);
    Py_XINCREF(cb);
    Py_XSETREF(g_struct_cb, cb);
    Py_RETURN_NONE;
}

static PyMethodDef methods[] = {
    {"decode", py_decode, METH_O,
     "decode(frame: bytes-like) -> object (wire.py-compatible)"},
    {"init", py_init, METH_VARARGS,
     "init(WireDecodeError, struct_cb(sid, vals) -> object)"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_rtpu_wirefast",
    "C decode path for the ray_tpu wire codec", -1, methods,
};

PyMODINIT_FUNC PyInit__rtpu_wirefast(void)
{
    return PyModule_Create(&moduledef);
}
