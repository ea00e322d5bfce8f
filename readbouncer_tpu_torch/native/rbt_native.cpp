// Native host-side I/O + encode functions of readbouncer_tpu_torch.
//
// The port's own copy of native/rbt_native.cpp, the JAX package's host
// layer: FASTA/FASTQ parsing, Dna5 base encoding, fixed-shape batch
// packing and the IBF build's insert loop, the pure-C++ equivalents of
// the reference's SeqAn I/O + alphabet layer (src/IBF/IBFBuild.cpp:52
// readRecords, Dna5 ordValue encoding).  The original's four functions
// are kept, with one change that keeps every output: the line reader
// searches for a line's end only in the bytes it has not searched yet
// (LineReader::getline), so a long line costs linear, not quadratic,
// time.  One function is the port's own: pack_codes, the batch packer
// of the upload path (the JAX package packs in numpy, pack4_np /
// pack5_np in readbouncer_tpu/classify/fused.py; it returns their
// bytes bit for bit).  The module's name differs: this is the CPython
// extension module readbouncer_tpu_torch.native._rbt_host.  The port
// has no Python fallback on its paths: readbouncer_tpu_torch/fastio,
// classify/engine.py and ibf/build.py call it, and their numpy / Python
// versions serve only as the plain versions the tests compare with.
//
// Build: readbouncer_tpu_torch/native/__init__.py::load_native() runs
// the host C++ compiler on first use (-O3 -std=c++20, -lz) into
// build/torch_host/.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// Dna5 ordValue: A=0 C=1 G=2 T=3 everything-else=4 (matches
// readbouncer_tpu_torch/ibf/hashing.py _BASE_LUT).
struct BaseLut {
    uint8_t tab[256];
    BaseLut() {
        memset(tab, 4, sizeof(tab));
        tab[(unsigned char)'A'] = 0; tab[(unsigned char)'a'] = 0;
        tab[(unsigned char)'C'] = 1; tab[(unsigned char)'c'] = 1;
        tab[(unsigned char)'G'] = 2; tab[(unsigned char)'g'] = 2;
        tab[(unsigned char)'T'] = 3; tab[(unsigned char)'t'] = 3;
    }
};
const BaseLut kLut;

// encode_into(seq, n, out): ASCII -> ordValues.
inline void encode_into(const char* seq, Py_ssize_t n, uint8_t* out) {
    for (Py_ssize_t i = 0; i < n; ++i) out[i] = kLut.tab[(unsigned char)seq[i]];
}

// ---------------------------------------------------------------------
// encode_batch(seqs: list[str|bytes], length: int) -> (bytes, bytes)
//
// Packs up to `length` encoded bases of each sequence into a row of a
// [len(seqs), length] uint8 buffer (zero padded) and returns
// (buffer_bytes, lengths_int32_bytes).  The Python side wraps both with
// numpy.frombuffer — zero copies beyond the single allocation here.
PyObject* encode_batch(PyObject*, PyObject* args) {
    PyObject* seqs;
    Py_ssize_t length;
    if (!PyArg_ParseTuple(args, "On", &seqs, &length)) return nullptr;
    if (!PyList_Check(seqs)) {
        PyErr_SetString(PyExc_TypeError, "seqs must be a list");
        return nullptr;
    }
    Py_ssize_t rows = PyList_GET_SIZE(seqs);
    PyObject* buf = PyBytes_FromStringAndSize(nullptr, rows * length);
    PyObject* lens = PyBytes_FromStringAndSize(nullptr, rows * 4);
    if (!buf || !lens) { Py_XDECREF(buf); Py_XDECREF(lens); return nullptr; }
    uint8_t* out = (uint8_t*)PyBytes_AS_STRING(buf);
    int32_t* lens_out = (int32_t*)PyBytes_AS_STRING(lens);
    memset(out, 0, rows * length);
    for (Py_ssize_t r = 0; r < rows; ++r) {
        PyObject* item = PyList_GET_ITEM(seqs, r);
        const char* data;
        Py_ssize_t n;
        if (PyUnicode_Check(item)) {
            data = PyUnicode_AsUTF8AndSize(item, &n);
            if (!data) { Py_DECREF(buf); Py_DECREF(lens); return nullptr; }
        } else if (PyBytes_Check(item)) {
            data = PyBytes_AS_STRING(item);
            n = PyBytes_GET_SIZE(item);
        } else {
            Py_DECREF(buf); Py_DECREF(lens);
            PyErr_SetString(PyExc_TypeError, "sequences must be str or bytes");
            return nullptr;
        }
        if (n > length) n = length;
        encode_into(data, n, out + r * length);
        lens_out[r] = (int32_t)n;
    }
    PyObject* result = PyTuple_Pack(2, buf, lens);
    Py_DECREF(buf);
    Py_DECREF(lens);
    return result;
}

// ---------------------------------------------------------------------
// encode(seq: str|bytes) -> bytes   (ordValues, same length)
PyObject* encode(PyObject*, PyObject* arg) {
    const char* data;
    Py_ssize_t n;
    if (PyUnicode_Check(arg)) {
        data = PyUnicode_AsUTF8AndSize(arg, &n);
        if (!data) return nullptr;
    } else if (PyBytes_Check(arg)) {
        data = PyBytes_AS_STRING(arg);
        n = PyBytes_GET_SIZE(arg);
    } else {
        PyErr_SetString(PyExc_TypeError, "seq must be str or bytes");
        return nullptr;
    }
    PyObject* out = PyBytes_FromStringAndSize(nullptr, n);
    if (!out) return nullptr;
    encode_into(data, n, (uint8_t*)PyBytes_AS_STRING(out));
    return out;
}

// ---------------------------------------------------------------------
// pack_codes(codes, mode: str, width: int = -1) -> (bytes, bool)
//
// Packs the first `width` columns (every column when -1) of each row of
// a 2-D uint8 buffer of base codes, read in place (rows may be strided,
// the bytes of a row must be adjacent, e.g. a column slice of a numpy
// array):
//   "2bit"    four codes a byte, c0 | c1<<2 | c2<<4 | c3<<6  (pack4_np)
//   "base243" three codes a byte, c0 + 5*c1 + 25*c2, kept mod 256 (pack5_np)
// A row's last byte is padded with code 0.  Returns the [rows, P]
// packed bytes and whether any code of the WHOLE buffer (every column,
// not only the packed ones) exceeds 3, i.e. holds an N: one pass decides
// a batch's packing and packs its first chunk.  The work is split over
// threads by rows, outside the interpreter lock.
template <int PER_BYTE>
inline void pack_row(const uint8_t* row, Py_ssize_t width, uint8_t* out) {
    Py_ssize_t full = width / PER_BYTE;
    for (Py_ssize_t p = 0; p < full; ++p) {
        const uint8_t* c = row + p * PER_BYTE;
        if (PER_BYTE == 4)
            out[p] = (uint8_t)(c[0] | (c[1] << 2) | (c[2] << 4) | (c[3] << 6));
        else
            out[p] = (uint8_t)(c[0] + 5 * c[1] + 25 * c[2]);
    }
    Py_ssize_t rest = width - full * PER_BYTE;
    if (rest) {
        uint8_t c[4] = {0, 0, 0, 0};
        for (Py_ssize_t i = 0; i < rest; ++i) c[i] = row[full * PER_BYTE + i];
        out[full] = PER_BYTE == 4
                        ? (uint8_t)(c[0] | (c[1] << 2) | (c[2] << 4) | (c[3] << 6))
                        : (uint8_t)(c[0] + 5 * c[1] + 25 * c[2]);
    }
}

PyObject* pack_codes(PyObject*, PyObject* args) {
    PyObject* obj;
    const char* mode;
    Py_ssize_t width = -1;
    if (!PyArg_ParseTuple(args, "Os|n", &obj, &mode, &width)) return nullptr;
    int per_byte;
    if (strcmp(mode, "2bit") == 0) per_byte = 4;
    else if (strcmp(mode, "base243") == 0) per_byte = 3;
    else {
        PyErr_Format(PyExc_ValueError, "unknown packing '%s' (2bit or base243)", mode);
        return nullptr;
    }
    Py_buffer view;
    if (PyObject_GetBuffer(obj, &view, PyBUF_STRIDES | PyBUF_FORMAT) < 0) return nullptr;
    const char* err = nullptr;
    if (view.ndim != 2) err = "codes must be a 2-D buffer";
    else if (view.itemsize != 1 || (view.format && strcmp(view.format, "B") != 0))
        err = "codes must be uint8";
    else if (view.shape[1] > 1 && view.strides[1] != 1)
        err = "the bytes of a row of codes must be adjacent";
    else if (width < -1 || width > view.shape[1]) err = "width out of range";
    if (err) {
        PyBuffer_Release(&view);
        PyErr_SetString(PyExc_ValueError, err);
        return nullptr;
    }
    Py_ssize_t rows = view.shape[0], cols = view.shape[1];
    Py_ssize_t stride = view.strides[0];
    if (width == -1) width = cols;
    Py_ssize_t P = (width + per_byte - 1) / per_byte;
    PyObject* buf = PyBytes_FromStringAndSize(nullptr, rows * P);
    if (!buf) { PyBuffer_Release(&view); return nullptr; }
    const uint8_t* src = (const uint8_t*)view.buf;
    uint8_t* out = (uint8_t*)PyBytes_AS_STRING(buf);
    std::atomic<bool> any_n(false);
    Py_BEGIN_ALLOW_THREADS;
    auto work = [&](Py_ssize_t r0, Py_ssize_t r1) {
        uint8_t acc = 0;
        for (Py_ssize_t r = r0; r < r1; ++r) {
            const uint8_t* row = src + r * stride;
            for (Py_ssize_t i = 0; i < cols; ++i) acc |= row[i];
            if (per_byte == 4) pack_row<4>(row, width, out + r * P);
            else pack_row<3>(row, width, out + r * P);
        }
        if (acc & 0xFC) any_n.store(true, std::memory_order_relaxed);
    };
    // one thread per ~1 MB of codes, at most the host's cores (8 at most)
    unsigned hw = std::max(1u, std::min(8u, std::thread::hardware_concurrency()));
    Py_ssize_t n_threads = std::min<Py_ssize_t>(hw, 1 + rows * cols / (1 << 20));
    if (n_threads <= 1) {
        work(0, rows);
    } else {
        std::vector<std::thread> pool;
        Py_ssize_t step = (rows + n_threads - 1) / n_threads;
        for (Py_ssize_t r0 = 0; r0 < rows; r0 += step)
            pool.emplace_back(work, r0, std::min(rows, r0 + step));
        for (auto& th : pool) th.join();
    }
    Py_END_ALLOW_THREADS;
    PyBuffer_Release(&view);
    PyObject* result = Py_BuildValue("(NO)", buf, any_n.load() ? Py_True : Py_False);
    return result;
}

// ---------------------------------------------------------------------
// read_records(path: str, first_word_id: bool) -> RecordReader
//
// Streaming FASTA/FASTQ record iterator (format sniffed from the first
// byte, like seqan::readRecords at src/IBF/IBFBuild.cpp:52).  Yields
// (id: str, seq: bytes) tuples one record at a time — constant memory
// for any file size.  Lines of any length are handled (growable buffer,
// no fgets truncation), CRLF is stripped, and gzip input is transparent
// (zlib gzFile reads plain files unchanged).  Ids are optionally cut at
// the first space/tab (reference seqid handling: src/IBF/IBFBuild.cpp:77).

struct LineReader {
    gzFile f = nullptr;
    std::string buf;     // window of the file
    size_t pos = 0;      // scan cursor into buf
    bool eof = false;
    bool io_error = false;

    static constexpr size_t kChunk = 1 << 18;

    bool fill() {  // append one chunk; false on EOF or error
        if (eof) return false;
        size_t old = buf.size();
        buf.resize(old + kChunk);
        int n = gzread(f, buf.data() + old, (unsigned)kChunk);
        if (n < 0) { io_error = true; eof = true; n = 0; }
        buf.resize(old + (size_t)n);
        if ((size_t)n < kChunk) eof = true;
        return n > 0;
    }

    // Next line (without terminator, \r stripped) into `line`.
    // Returns false at end of input.  `line` stays valid until the next
    // call (it is a copy — headers/sequences escape the window buffer).
    bool getline(std::string& line) {
        size_t nl, from = pos;
        while ((nl = buf.find('\n', from)) == std::string::npos) {
            // the window up to here holds no '\n': search only what fill()
            // appends (the JAX package's copy searches from pos again,
            // quadratic in a line's length)
            from = buf.size();
            if (!fill()) {
                if (pos >= buf.size()) return false;
                nl = buf.size();
                break;
            }
        }
        size_t n = nl - pos;
        if (n && buf[pos + n - 1] == '\r') --n;
        line.assign(buf, pos, n);
        pos = (nl == buf.size()) ? nl : nl + 1;
        // compact the consumed prefix so the window stays bounded
        if (pos > (kChunk * 2) && pos * 2 > buf.size()) {
            buf.erase(0, pos);
            pos = 0;
        }
        return true;
    }

    int peek() {
        while (pos >= buf.size()) {
            if (!fill()) return -1;
        }
        return (unsigned char)buf[pos];
    }
};

struct RecordReader {
    PyObject_HEAD
    LineReader* lr;
    std::string* line;     // scratch
    std::string* header;   // pending FASTA header (already id-trimmed)
    std::string* seq;
    bool fastq;
    bool first_word_id;
    bool done;
};

void trim_id(std::string& id, bool first_word) {
    if (!first_word) return;
    size_t sp = id.find_first_of(" \t");
    if (sp != std::string::npos) id.resize(sp);
}

PyObject* make_record(const std::string& id, const std::string& seq) {
    PyObject* pid = PyUnicode_FromStringAndSize(id.data(), id.size());
    if (!pid) return nullptr;
    PyObject* pseq = PyBytes_FromStringAndSize(seq.data(), seq.size());
    if (!pseq) { Py_DECREF(pid); return nullptr; }
    PyObject* tup = PyTuple_Pack(2, pid, pseq);
    Py_DECREF(pid);
    Py_DECREF(pseq);
    return tup;
}

PyObject* reader_next(PyObject* self_obj) {
    RecordReader* self = (RecordReader*)self_obj;
    if (self->done) return nullptr;  // StopIteration (iternext protocol)
    LineReader& lr = *self->lr;
    std::string& line = *self->line;
    std::string& seq = *self->seq;

    if (!self->fastq) {
        // FASTA: need a header in hand, then accumulate until next '>'
        while (self->header->empty()) {
            if (!lr.getline(line)) { self->done = true; goto eof; }
            if (!line.empty() && line[0] == '>') {
                self->header->assign(line, 1, line.size() - 1);
                trim_id(*self->header, self->first_word_id);
                // ">" alone is a valid (empty-id) header; mark in-record
                // via a non-empty sentinel handled below
                if (self->header->empty()) self->header->assign(1, '\0');
            }
        }
        seq.clear();
        while (true) {
            if (!lr.getline(line)) { self->done = true; break; }
            if (!line.empty() && line[0] == '>') {
                std::string id = (*self->header)[0] == '\0'
                                     ? std::string()
                                     : *self->header;
                self->header->assign(line, 1, line.size() - 1);
                trim_id(*self->header, self->first_word_id);
                if (self->header->empty()) self->header->assign(1, '\0');
                if (lr.io_error) goto ioerr;
                return make_record(id, seq);
            }
            seq.append(line);
        }
        if (lr.io_error) goto ioerr;
        {
            std::string id = (*self->header)[0] == '\0' ? std::string()
                                                        : *self->header;
            self->header->clear();
            return make_record(id, seq);
        }
    }

    // FASTQ: 4-line records (header/seq/plus/qual); blank lines between
    // records are skipped, malformed records raise ValueError — matching
    // the Python version (readbouncer_tpu_torch/fastio/fasta.py _iter_fastq).
    while (true) {
        if (!lr.getline(line)) { self->done = true; goto eof; }
        if (line.empty()) continue;
        break;
    }
    if (line[0] != '@') {
        PyErr_Format(PyExc_ValueError, "malformed FASTQ record header: %.60s",
                     line.c_str());
        self->done = true;
        return nullptr;
    }
    {
        std::string id(line, 1, line.size() - 1);
        trim_id(id, self->first_word_id);
        if (!lr.getline(seq)) seq.clear();
        if (!lr.getline(line)) line.clear();
        if (line.empty() || line[0] != '+') {
            PyErr_SetString(PyExc_ValueError,
                            "malformed FASTQ record: missing '+' line");
            self->done = true;
            return nullptr;
        }
        lr.getline(line);  // quality line, unused
        if (lr.io_error) goto ioerr;
        return make_record(id, seq);
    }

eof:
    if (lr.io_error) goto ioerr;
    return nullptr;
ioerr:
    PyErr_SetString(PyExc_OSError, "I/O or decompression error while reading");
    return nullptr;
}

void reader_dealloc(PyObject* self_obj) {
    RecordReader* self = (RecordReader*)self_obj;
    if (self->lr) {
        if (self->lr->f) gzclose(self->lr->f);
        delete self->lr;
    }
    delete self->line;
    delete self->header;
    delete self->seq;
    Py_TYPE(self_obj)->tp_free(self_obj);
}

PyTypeObject RecordReaderType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
    "readbouncer_tpu_torch.native._rbt_host.RecordReader",  // tp_name
    sizeof(RecordReader),                    // tp_basicsize
};

PyObject* read_records(PyObject*, PyObject* args) {
    const char* path;
    int first_word_id = 0;
    if (!PyArg_ParseTuple(args, "s|p", &path, &first_word_id)) return nullptr;
    gzFile f = gzopen(path, "rb");
    if (!f) {
        PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
        return nullptr;
    }
    gzbuffer(f, 1 << 17);
    RecordReader* self =
        (RecordReader*)RecordReaderType.tp_alloc(&RecordReaderType, 0);
    if (!self) { gzclose(f); return nullptr; }
    self->lr = new LineReader();
    self->lr->f = f;
    self->line = new std::string();
    self->header = new std::string();
    self->seq = new std::string();
    self->first_word_id = first_word_id != 0;
    self->done = false;
    self->fastq = self->lr->peek() == '@';
    return (PyObject*)self;
}

// ---------------------------------------------------------------------
// insert_fragments: the IBF build hot loop in native code.
//
// Equivalent of the reference's reader+worker insertKmer pipeline
// (src/IBF/IBFBuild.cpp:28,143-215) for the rbt1 hash scheme
// (readbouncer_tpu_torch/ibf/hashing.py): for every fragment, every forward
// k-mer window is hashed h ways and its bit set in the fragment's bin.
// Fragments are distributed over worker threads; bit sets use atomic
// fetch-OR, so overlapping windows from concurrent fragments are safe
// (unlike the reference's unsynchronized shared binid,
// src/IBF/IBFBuild.cpp:141).

// rbt1 constants — MUST match readbouncer_tpu_torch/ibf/hashing.py.
const uint32_t kSeeds[5] = {0x9E3779B1u, 0x85EBCA77u, 0xC2B2AE3Du,
                            0x27D4EB2Fu, 0x165667B1u};

inline uint32_t fmix32(uint32_t z) {
    z ^= z >> 16;
    z *= 0x85EBCA6Bu;
    z ^= z >> 13;
    z *= 0xC2B2AE35u;
    z ^= z >> 16;
    return z;
}

struct FragSpan {
    int64_t start, end, bin;
};

// rbt2 row derivation — MUST match ibf/hashing.py block_offsets_np:
// block = fastrange(fmix32(code*SEED0), rows/8); h distinct offsets in
// [0,8) from fmix32(code*SEED1) by order-statistics insertion.
inline void rbt2_rows(uint32_t code, uint32_t n_blocks, int h,
                      uint32_t* rows_out) {
    uint32_t z0 = fmix32(code * kSeeds[0]);
    uint32_t block = (uint32_t)(((uint64_t)z0 * n_blocks) >> 32);
    uint32_t v = fmix32(code * kSeeds[1]);
    uint32_t offs[8];
    offs[0] = v & 7u;
    for (int i = 1; i < h; ++i) {
        uint32_t t = (v >> (3 * i)) % (uint32_t)(8 - i);
        uint32_t prior[8];
        for (int j = 0; j < i; ++j) prior[j] = offs[j];
        std::sort(prior, prior + i);
        for (int j = 0; j < i; ++j) t += (t >= prior[j]) ? 1u : 0u;
        offs[i] = t;
    }
    for (int i = 0; i < h; ++i) rows_out[i] = block * 8u + offs[i];
}

// One fragment: rolling base-5 window codes -> h hashed rows -> atomic OR.
void insert_one_fragment(uint32_t* bits, uint32_t rows, uint32_t words,
                         const uint8_t* bases, const FragSpan& frag,
                         int k, int h, int scheme) {
    int64_t len = frag.end - frag.start;
    if (len < k) return;
    const uint8_t* b = bases + frag.start;
    uint32_t word = (uint32_t)(frag.bin / 32);
    uint32_t mask = 1u << (frag.bin % 32);
    // 5^(k-1) mod 2^32 for the rolling update
    uint32_t pow5k1 = 1;
    for (int i = 0; i < k - 1; ++i) pow5k1 *= 5u;
    uint32_t code = 0;
    for (int t = 0; t < k; ++t) code = code * 5u + b[t];
    int64_t n = len - k + 1;
    uint32_t n_blocks = rows / 8u;
    for (int64_t j = 0;;) {
        uint32_t rws[8];
        if (scheme == 1) {
            rbt2_rows(code, n_blocks, h, rws);
        } else {
            for (int i = 0; i < h; ++i) {
                uint32_t z = fmix32(code * kSeeds[i]);
                rws[i] = (uint32_t)(((uint64_t)z * rows) >> 32);
            }
        }
        for (int i = 0; i < h; ++i) {
            std::atomic_ref<uint32_t> cell(bits[(uint64_t)rws[i] * words + word]);
            cell.fetch_or(mask, std::memory_order_relaxed);
        }
        if (++j >= n) break;
        code = (code - (uint32_t)b[j - 1] * pow5k1) * 5u + b[j + k - 1];
    }
}

// insert_fragments(bits: writable buffer u32[rows*words], rows, words,
//                  bases: bytes (encoded ordValues), frags: bytes
//                  (int64 [n,3] start/end/bin), k, h, threads) -> None
PyObject* insert_fragments(PyObject*, PyObject* args) {
    Py_buffer bits_buf;
    Py_ssize_t rows, words;
    const char* bases;
    Py_ssize_t bases_n;
    const char* frags_raw;
    Py_ssize_t frags_n;
    int k, h, n_threads;
    int scheme = 0;  // 0 = rbt1, 1 = rbt2 (blocked rows)
    if (!PyArg_ParseTuple(args, "w*nny#y#iii|i", &bits_buf, &rows, &words,
                          &bases, &bases_n, &frags_raw, &frags_n, &k, &h,
                          &n_threads, &scheme))
        return nullptr;
    if (scheme == 1 && (rows % 8 || h > 8)) {
        PyBuffer_Release(&bits_buf);
        PyErr_SetString(PyExc_ValueError, "rbt2 needs rows%8==0 and h<=8");
        return nullptr;
    }
    if (bits_buf.len < (Py_ssize_t)(rows * words * 4)) {
        PyBuffer_Release(&bits_buf);
        PyErr_SetString(PyExc_ValueError, "bits buffer too small");
        return nullptr;
    }
    if (frags_n % (3 * 8) != 0) {
        PyBuffer_Release(&bits_buf);
        PyErr_SetString(PyExc_ValueError, "frags must be int64 [n,3]");
        return nullptr;
    }
    if (k < 1 || k > 16 || h < 1 || h > 5) {
        PyBuffer_Release(&bits_buf);
        PyErr_SetString(PyExc_ValueError, "need 1<=k<=16, 1<=h<=5");
        return nullptr;
    }
    size_t n_frags = (size_t)frags_n / 24;
    const FragSpan* frags = (const FragSpan*)frags_raw;
    uint32_t* bits = (uint32_t*)bits_buf.buf;
    for (size_t f = 0; f < n_frags; ++f) {
        if (frags[f].start < 0 || frags[f].end > bases_n ||
            frags[f].bin < 0 || frags[f].bin >= (int64_t)words * 32) {
            PyBuffer_Release(&bits_buf);
            PyErr_SetString(PyExc_ValueError, "fragment out of range");
            return nullptr;
        }
    }
    if (n_threads < 1) n_threads = 1;
    if ((size_t)n_threads > n_frags) n_threads = n_frags ? (int)n_frags : 1;
    Py_BEGIN_ALLOW_THREADS;
    if (n_threads == 1) {
        for (size_t f = 0; f < n_frags; ++f)
            insert_one_fragment(bits, (uint32_t)rows, (uint32_t)words,
                                (const uint8_t*)bases, frags[f], k, h, scheme);
    } else {
        std::atomic<size_t> next(0);
        std::vector<std::thread> pool;
        pool.reserve(n_threads);
        for (int t = 0; t < n_threads; ++t) {
            pool.emplace_back([&]() {
                for (size_t f = next.fetch_add(1); f < n_frags;
                     f = next.fetch_add(1))
                    insert_one_fragment(bits, (uint32_t)rows, (uint32_t)words,
                                        (const uint8_t*)bases, frags[f], k, h, scheme);
            });
        }
        for (auto& th : pool) th.join();
    }
    Py_END_ALLOW_THREADS;
    PyBuffer_Release(&bits_buf);
    Py_RETURN_NONE;
}

PyMethodDef kMethods[] = {
    {"insert_fragments", insert_fragments, METH_VARARGS,
     "insert_fragments(bits, rows, words, bases, frags_i64x3, k, h, threads)"},
    {"encode_batch", encode_batch, METH_VARARGS,
     "encode_batch(seqs, length) -> (u8 bytes [R*length], i32 bytes [R])"},
    {"encode", encode, METH_O, "encode(seq) -> ordValue bytes"},
    {"pack_codes", pack_codes, METH_VARARGS,
     "pack_codes(codes_u8_2d, '2bit'|'base243', width=-1) -> (packed bytes [R*P], any code > 3)"},
    {"read_records", read_records, METH_VARARGS,
     "read_records(path, first_word_id=False) -> iterator of (id, seq_bytes);"
     " gzip transparent, streaming"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef kModule = {
    PyModuleDef_HEAD_INIT, "_rbt_host",
    "native host-side I/O + encode kernels", -1, kMethods,
};

}  // namespace

PyMODINIT_FUNC PyInit__rbt_host(void) {
    RecordReaderType.tp_dealloc = reader_dealloc;
    RecordReaderType.tp_flags = Py_TPFLAGS_DEFAULT;
    RecordReaderType.tp_doc = "streaming FASTA/FASTQ record iterator";
    RecordReaderType.tp_iter = PyObject_SelfIter;
    RecordReaderType.tp_iternext = reader_next;
    RecordReaderType.tp_new = nullptr;  // only created via read_records()
    if (PyType_Ready(&RecordReaderType) < 0) return nullptr;
    PyObject* mod = PyModule_Create(&kModule);
    if (!mod) return nullptr;
    Py_INCREF(&RecordReaderType);
    if (PyModule_AddObject(mod, "RecordReader",
                           (PyObject*)&RecordReaderType) < 0) {
        Py_DECREF(&RecordReaderType);
        Py_DECREF(mod);
        return nullptr;
    }
    return mod;
}
