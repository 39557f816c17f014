// Fast HITRAN .par record scanner.
//
// Native tier of the line-list ingest path (the reference's pylineread
// is pure Python and takes "a few minutes to an hour" per database,
// manual tex:914; HITEMP line files run to tens of GB, where Python
// fixed-width parsing is the bottleneck).  This scanner memory-reads
// the file once and parses the 2004-format fixed-width fields with
// branch-light C++.
//
// Exposed via ctypes (no pybind11 in the image):
//   hitran_count(path)               -> number of records
//   hitran_parse(path, out arrays)   -> fills caller-allocated buffers
//
// Build: g++ -O3 -march=native -shared -fPIC hitran_scan.cpp -o libhitran_scan.so

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

// Parse a fixed-width field as double; tolerates leading/trailing
// blanks and real-archive quirks: Fortran 'D'/'d' exponents are
// normalized to 'E'/'e' (strtod would otherwise stop at the 'D' and
// silently return the mantissa — a 19-order-of-magnitude corruption
// on an intensity field).  Unparseable content returns NaN so the
// Python wrapper can detect it and fall back to the tolerant
// diagnostic parser rather than ingest garbage.  ``blank_is_nan``
// marks an all-blank REQUIRED field (wn0, S296, E'') as NaN too —
// ingesting it as 0.0 would plant a wn=0 line in the list while the
// diagnostic parser would have reported it; blank OPTIONAL fields
// (widths, exponents) keep the 0.0 default.
static inline double field_to_double(const char* p, int width,
                                     bool blank_is_nan = false) {
    char buf[32];
    int n = 0;
    for (int i = 0; i < width && n < 31; ++i) {
        char c = p[i];
        if (c == ' ') continue;
        if (c == 'D') c = 'E';
        else if (c == 'd') c = 'e';
        buf[n++] = c;
    }
    buf[n] = '\0';
    if (n == 0) return blank_is_nan ? std::nan("") : 0.0;
    char* endp = nullptr;
    double v = std::strtod(buf, &endp);
    if (endp != buf + n) return std::nan("");
    return v;
}

static inline int iso_char_to_index(char c) {
    if (c >= '1' && c <= '9') return c - '0';
    if (c == '0') return 10;
    if (c >= 'A' && c <= 'Z') return c - 'A' + 11;
    return 0;
}

struct FileBuf {
    char* data = nullptr;
    size_t size = 0;
    ~FileBuf() { std::free(data); }
    bool read(const char* path) {
        FILE* f = std::fopen(path, "rb");
        if (!f) return false;
        std::fseek(f, 0, SEEK_END);
        long sz = std::ftell(f);
        std::fseek(f, 0, SEEK_SET);
        if (sz <= 0) { std::fclose(f); return false; }
        data = static_cast<char*>(std::malloc(static_cast<size_t>(sz)));
        size = std::fread(data, 1, static_cast<size_t>(sz), f);
        std::fclose(f);
        return size > 0;
    }
};

// Iterate record lines (>= 59 chars = molec..n_air, matching the
// Python parser's minimal-record width; CR of CRLF endings stripped;
// '#' comments skipped).
template <typename Fn>
static void for_each_record(const FileBuf& fb, Fn&& fn) {
    const char* p = fb.data;
    const char* end = fb.data + fb.size;
    while (p < end) {
        const char* nl = static_cast<const char*>(
            std::memchr(p, '\n', static_cast<size_t>(end - p)));
        const char* line_end = nl ? nl : end;
        size_t len = static_cast<size_t>(line_end - p);
        if (len > 0 && p[len - 1] == '\r') --len;
        if (len >= 59 && p[0] != '#') fn(p, len);
        p = nl ? nl + 1 : end;
    }
}

}  // namespace

extern "C" {

long hitran_count(const char* path) {
    FileBuf fb;
    if (!fb.read(path)) return -1;
    long count = 0;
    for_each_record(fb, [&](const char*, size_t) { ++count; });
    return count;
}

// All output arrays must have capacity >= hitran_count(path).
// Field layout (HITRAN 2004+): M[0:2] I[2:3] nu[3:15] S[15:25] A[25:35]
// gair[35:40] gself[40:45] E''[45:55] nair[55:59] dair[59:67].
long hitran_parse(const char* path, int32_t* mol_id, int8_t* iso,
                  double* wn, double* s296, double* gamma_air,
                  double* gamma_self, double* elower, double* n_air) {
    FileBuf fb;
    if (!fb.read(path)) return -1;
    long i = 0;
    for_each_record(fb, [&](const char* p, size_t) {
        mol_id[i] = static_cast<int32_t>(field_to_double(p, 2));
        iso[i] = static_cast<int8_t>(iso_char_to_index(p[2]));
        wn[i] = field_to_double(p + 3, 12, /*blank_is_nan=*/true);
        s296[i] = field_to_double(p + 15, 10, /*blank_is_nan=*/true);
        gamma_air[i] = field_to_double(p + 35, 5);
        gamma_self[i] = field_to_double(p + 40, 5);
        elower[i] = field_to_double(p + 45, 10, /*blank_is_nan=*/true);
        n_air[i] = field_to_double(p + 55, 4);
        ++i;
    });
    return i;
}

}  // extern "C"
