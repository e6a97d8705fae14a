// Native host-side data loader for khmer-tpu.
//
// The TPU-native equivalent of the reference's C++ read-parsing layer
// (src/oxli/read_parsers.cc:336-398, SeqAn FastxReader): parses
// FASTA/FASTQ (plain, gzip, or bzip2; file, pipe, or stdin), cleans reads (uppercase, non-ACGT -> A,
// reference include/oxli/read_parsers.hh:122-138), 2-bit encodes them
// (A=0 T=1 C=2 G=3, include/oxli/kmer_hash.hh:70-77), and packs the
// code stream into fixed-size device chunks with per-window validity
// masks — the exact semantics of khmer_tpu_torch.hashtable._FlatBatcher
// (reads spanning a chunk boundary re-emit their last k-1 bases so
// every k-mer window lands in exactly one chunk).
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC fastx_loader.cc -lz \
//            -l:libbz2.so.1 -o libkhmer_io.so

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

#include <zlib.h>

// libbz2 ships in this image without its header; the streaming ABI is
// stable, declare just what the decompressor needs (bzlib.h layout).
extern "C" {
typedef struct {
    char* next_in;
    unsigned int avail_in;
    unsigned int total_in_lo32;
    unsigned int total_in_hi32;
    char* next_out;
    unsigned int avail_out;
    unsigned int total_out_lo32;
    unsigned int total_out_hi32;
    void* state;
    void* (*bzalloc)(void*, int, int);
    void (*bzfree)(void*, void*);
    void* opaque;
} kio_bz_stream;
int BZ2_bzDecompressInit(kio_bz_stream*, int verbosity, int small);
int BZ2_bzDecompress(kio_bz_stream*);
int BZ2_bzDecompressEnd(kio_bz_stream*);
}
#define KIO_BZ_OK 0
#define KIO_BZ_STREAM_END 4

namespace {

// Unified byte source: raw fd (regular file, pipe, or stdin) with
// magic-sniffed gzip/bzip2 decompression — the reference parses all
// of FASTA/FASTQ+gz+bz2 and stdin through one SeqAn stream the same
// way (src/oxli/read_parsers.cc:336-361).
struct Source {
    int fd = -1;
    bool own_fd = false;
    enum Mode { PLAIN, GZIP, BZIP2 } mode = PLAIN;
    z_stream zs;
    bool z_init = false;
    kio_bz_stream bz;
    bool bz_init = false;
    std::vector<unsigned char> in;
    size_t in_pos = 0, in_len = 0;
    bool raw_eof = false;
    bool stream_end = false;
    int err = 0;

    ~Source() { close_all(); }

    void close_all() {
        if (z_init) { inflateEnd(&zs); z_init = false; }
        if (bz_init) { BZ2_bzDecompressEnd(&bz); bz_init = false; }
        if (fd >= 0 && own_fd) { ::close(fd); }
        fd = -1;
    }

    bool fill_raw() {
        if (raw_eof) return false;
        if (in.empty()) in.resize(1 << 20);
        ssize_t n;
        do {
            n = ::read(fd, in.data(), in.size());
        } while (n < 0 && errno == EINTR);
        if (n <= 0) { raw_eof = true; return false; }
        in_len = (size_t)n;
        in_pos = 0;
        return true;
    }

    bool open_path(const char* path) {
        if (strcmp(path, "-") == 0 || strcmp(path, "/dev/stdin") == 0) {
            fd = 0;
            own_fd = false;
        } else {
            fd = ::open(path, O_RDONLY);
            if (fd < 0) return false;
            own_fd = true;
        }
        fill_raw();
        const unsigned char* m = in.data();
        size_t n = in_len;
        if (n >= 2 && m[0] == 0x1f && m[1] == 0x8b) {
            mode = GZIP;
            memset(&zs, 0, sizeof(zs));
            if (inflateInit2(&zs, 15 + 32) != Z_OK) return false;
            z_init = true;
        } else if (n >= 3 && m[0] == 'B' && m[1] == 'Z' && m[2] == 'h') {
            mode = BZIP2;
            memset(&bz, 0, sizeof(bz));
            if (BZ2_bzDecompressInit(&bz, 0, 0) != KIO_BZ_OK)
                return false;
            bz_init = true;
        } else {
            mode = PLAIN;
        }
        return true;
    }

    // decompressed read; returns bytes produced, 0 at EOF, -1 on error
    long read_bytes(char* out, size_t want) {
        if (mode == PLAIN) {
            size_t got = 0;
            while (got < want) {
                if (in_pos >= in_len && !fill_raw()) break;
                size_t n = in_len - in_pos;
                if (n > want - got) n = want - got;
                memcpy(out + got, in.data() + in_pos, n);
                in_pos += n;
                got += n;
            }
            return (long)got;
        }
        size_t got = 0;
        while (got < want) {
            if (in_pos >= in_len && !raw_eof) fill_raw();
            bool have_in = in_pos < in_len;
            if (!have_in && stream_end) break;
            if (mode == GZIP) {
                zs.next_in = in.data() + in_pos;
                zs.avail_in = (unsigned)(in_len - in_pos);
                zs.next_out = (unsigned char*)(out + got);
                zs.avail_out = (unsigned)(want - got);
                int rc = inflate(&zs, Z_NO_FLUSH);
                in_pos = in_len - zs.avail_in;
                got = want - zs.avail_out;
                if (rc == Z_STREAM_END) {
                    // concatenated members (bgzf etc.): restart
                    if (in_pos < in_len || fill_raw()) {
                        inflateReset2(&zs, 15 + 32);
                    } else {
                        stream_end = true;
                        break;
                    }
                } else if (rc != Z_OK && rc != Z_BUF_ERROR) {
                    err = 1;
                    return -1;
                } else if (!have_in && raw_eof) {
                    break;  // truncated input: return what we have
                }
            } else {  // BZIP2
                bz.next_in = (char*)in.data() + in_pos;
                bz.avail_in = (unsigned)(in_len - in_pos);
                bz.next_out = out + got;
                bz.avail_out = (unsigned)(want - got);
                int rc = BZ2_bzDecompress(&bz);
                in_pos = in_len - bz.avail_in;
                got = want - bz.avail_out;
                if (rc == KIO_BZ_STREAM_END) {
                    if (in_pos < in_len || fill_raw()) {
                        BZ2_bzDecompressEnd(&bz);
                        memset(&bz, 0, sizeof(bz));
                        BZ2_bzDecompressInit(&bz, 0, 0);
                    } else {
                        stream_end = true;
                        break;
                    }
                } else if (rc != KIO_BZ_OK) {
                    err = 1;
                    return -1;
                } else if (!have_in && raw_eof) {
                    break;
                }
            }
        }
        return (long)got;
    }
};

struct Loader {
    Source src;
    int k = 0;
    long chunk = 0;

    // raw line buffering
    std::vector<char> buf;
    size_t buf_pos = 0, buf_len = 0;
    bool eof = false;

    // current encoded read + resume offset (for boundary re-emission)
    std::vector<uint8_t> codes;
    size_t read_start = 0;
    bool read_active = false;
    bool is_fastq = false;
    bool format_known = false;

    // chunk assembly state
    long filled = 0;

    // statistics
    uint64_t n_reads = 0;
    uint64_t n_consumed = 0;  // total k-mers (reads >= k contribute n-k+1)
    uint64_t n_bases = 0;

    // line-spill assembly (lines crossing a refill boundary) and the
    // one-line FASTA-header lookahead; both reused across reads so the
    // steady state allocates nothing per read
    std::string linebuf;
    std::string pending_line;
    bool have_pending = false;

    int err = 0;
};

const uint8_t* code_lut() {
    static uint8_t lut[256];
    static bool init = false;
    if (!init) {
        // cleaned-read semantics: everything -> A(0) except T/C/G
        memset(lut, 0, sizeof(lut));
        lut[(unsigned)'T'] = 1; lut[(unsigned)'t'] = 1;
        lut[(unsigned)'C'] = 2; lut[(unsigned)'c'] = 2;
        lut[(unsigned)'G'] = 3; lut[(unsigned)'g'] = 3;
        init = true;
    }
    return lut;
}

// View of the next line (without trailing newline/CR); returns false
// at EOF.  The view stays valid only until the next next_line() call —
// it points into the decompression buffer in the common case (zero
// copies, zero allocations) and into L->linebuf when the line spans a
// buffer refill.
bool next_line(Loader* L, const char** p, size_t* len) {
    if (L->have_pending) {
        L->have_pending = false;
        *p = L->pending_line.data();
        *len = L->pending_line.size();
        return true;
    }
    // fast path: the whole line is already in the buffer
    if (L->buf_pos < L->buf_len) {
        char* base = L->buf.data() + L->buf_pos;
        size_t avail = L->buf_len - L->buf_pos;
        char* nl = (char*)memchr(base, '\n', avail);
        if (nl) {
            size_t n = (size_t)(nl - base);
            L->buf_pos += n + 1;
            if (n && base[n - 1] == '\r') n--;
            *p = base;
            *len = n;
            return true;
        }
    }
    // slow path: assemble across one or more refills
    L->linebuf.clear();
    for (;;) {
        if (L->buf_pos >= L->buf_len) {
            if (L->eof) break;
            if (L->buf.empty()) L->buf.resize(1 << 20);
            long n = L->src.read_bytes(L->buf.data(), L->buf.size());
            if (n < 0) { L->err = 1; L->eof = true; break; }
            if (n == 0) { L->eof = true; break; }
            L->buf_len = (size_t)n;
            L->buf_pos = 0;
        }
        char* base = L->buf.data() + L->buf_pos;
        size_t avail = L->buf_len - L->buf_pos;
        char* nl = (char*)memchr(base, '\n', avail);
        if (nl) {
            L->linebuf.append(base, nl - base);
            L->buf_pos += (nl - base) + 1;
            break;
        }
        L->linebuf.append(base, avail);
        L->buf_pos = L->buf_len;
    }
    size_t n = L->linebuf.size();
    if (n && L->linebuf[n - 1] == '\r') n--;
    *p = L->linebuf.data();
    *len = n;
    return !(n == 0 && L->eof && L->buf_pos >= L->buf_len);
}

// stash a just-returned line (the FASTA lookahead header) so the next
// next_line() call re-delivers it; copies because the view's storage
// may be overwritten by the next buffer refill
void push_line(Loader* L, const char* p, size_t len) {
    L->pending_line.assign(p, len);
    L->have_pending = true;
}

// append a cleaned+2-bit-encoded sequence line to L->codes
void encode_append(Loader* L, const char* p, size_t len) {
    const uint8_t* lut = code_lut();
    size_t off = L->codes.size();
    L->codes.resize(off + len);
    uint8_t* out = L->codes.data() + off;
    for (size_t i = 0; i < len; i++)
        out[i] = lut[(unsigned char)p[i]];
}

// parse the next read's sequence into L->codes; false when exhausted
bool next_read(Loader* L) {
    const char* line; size_t n;
    for (;;) {
        if (!next_line(L, &line, &n)) return false;
        if (n != 0) break;
    }
    if (!L->format_known) {
        if (line[0] == '@') L->is_fastq = true;
        else if (line[0] == '>') L->is_fastq = false;
        else { L->err = 2; return false; }
        L->format_known = true;
    }
    L->codes.clear();
    if (L->is_fastq) {
        if (line[0] != '@') { L->err = 2; return false; }
        const char* seq; size_t seqn;
        if (!next_line(L, &seq, &seqn)) { L->err = 2; return false; }
        encode_append(L, seq, seqn);  // before the next refill clobbers it
        const char* plus; size_t plusn;
        if (!next_line(L, &plus, &plusn) || plusn == 0 || plus[0] != '+') {
            L->err = 2; return false;
        }
        const char* qual; size_t qualn;  // scanned, never copied
        if (!next_line(L, &qual, &qualn)) { L->err = 2; return false; }
    } else {
        if (line[0] != '>') { L->err = 2; return false; }
        const char* part; size_t partn;
        for (;;) {
            if (!next_line(L, &part, &partn)) break;
            if (partn != 0 && part[0] == '>') {
                push_line(L, part, partn);
                break;
            }
            encode_append(L, part, partn);
        }
    }
    L->n_reads++;
    L->n_bases += L->codes.size();
    if ((long)L->codes.size() >= L->k)
        L->n_consumed += L->codes.size() - L->k + 1;
    L->read_start = 0;
    L->read_active = true;
    return true;
}

}  // namespace

extern "C" {

void* kio_open(const char* path, int k, long chunk) {
    Loader* L = new Loader();
    L->k = k;
    L->chunk = chunk;
    if (!L->src.open_path(path)) { delete L; return nullptr; }
    return L;
}

// Fill one chunk of `data` codes and `mask` window-validity flags.
// Returns: chunk  -> a full chunk was produced (call again)
//          0..chunk-1 -> final partial chunk of that many bytes
//                        (mask beyond is zeroed); subsequent calls
//                        return -1
//          -1 -> exhausted;  -2 -> parse error
long kio_next_chunk(void* handle, uint8_t* data, uint8_t* mask) {
    Loader* L = (Loader*)handle;
    if (L->err) return -2;
    const long chunk = L->chunk;
    const int k = L->k;
    long filled = 0;
    memset(mask, 0, chunk);

    for (;;) {
        if (!L->read_active) {
            if (!next_read(L)) {
                if (L->err) return -2;
                if (filled == 0) return -1;
                memset(data + filled, 0, chunk - filled);
                return filled;
            }
        }
        // copy a piece of the current read into the chunk
        // (_FlatBatcher.add semantics, khmer_tpu_torch/hashtable.py)
        long n = (long)L->codes.size();
        long start = (long)L->read_start;
        long space = chunk - filled;
        long take = n - start < space ? n - start : space;
        if (take > 0) {
            memcpy(data + filled, L->codes.data() + start, take);
            long nvalid = (n - start) - k + 1;  // windows inside the read
            if (nvalid > 0) {
                long m = nvalid < take ? nvalid : take;
                memset(mask + filled, 1, m);
            }
            filled += take;
        }
        if (filled == chunk) {
            // first window not evaluated in this chunk resumes next one
            long next_start = start + take - (k - 1);
            if (next_start < 0) next_start = 0;
            if (n - next_start < k) {
                L->read_active = false;
            } else {
                L->read_start = (size_t)next_start;
            }
            return chunk;
        }
        L->read_active = false;
    }
}

void kio_stats(void* handle, uint64_t* n_reads, uint64_t* n_consumed,
               uint64_t* n_bases) {
    Loader* L = (Loader*)handle;
    if (n_reads) *n_reads = L->n_reads;
    if (n_consumed) *n_consumed = L->n_consumed;
    if (n_bases) *n_bases = L->n_bases;
}

void kio_close(void* handle) {
    Loader* L = (Loader*)handle;
    L->src.close_all();
    delete L;
}

}  // extern "C"

extern "C" {

// version stamp compiled into the native runtime; the python layer
// compares it with the package version (khmer.__version_cpp__()
// parity, reference tests/test_version.py)
#ifndef KHMER_TPU_VERSION
#define KHMER_TPU_VERSION "unknown"
#endif
const char* kio_version() { return KHMER_TPU_VERSION; }

}  // extern "C"
