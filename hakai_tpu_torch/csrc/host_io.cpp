// host_io: the port's host-side number parser and formatters (C++).
//
// Host code, not a kernel: the port's own copy of the JAX package's
// native/hakai_native.cpp, with the entry points renamed into the port's
// hk_ namespace.  The .inp reader parses every node and element block
// through hk_parse_numbers (strtod), and the VTK writer formats every
// float block through hk_format_e and the CELLS rows through hk_format_i
// (snprintf "%1.6e" and "%d", the reference's number format,
// HAKAI_j.jl:3574).  Loaded with ctypes by hakai_tpu_torch/io/native.py;
// built at first use by hakai_tpu_torch/_build.py:host_library with the
// host compiler (-O3 -fPIC -shared -Wall).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>

extern "C" {

// Parse every number in the buffer: at each character that can start a
// float literal ([0-9+-.]) strtod is tried, and what it reads is taken;
// every other character is a separator.  Returns the count written, or -1
// on overflow of cap.
int64_t hk_parse_numbers(const char* s, int64_t n, double* out,
                         int64_t cap) {
    int64_t count = 0;
    const char* p = s;
    const char* end = s + n;
    while (p < end) {
        char c = *p;
        if ((c >= '0' && c <= '9') || c == '-' || c == '+' || c == '.') {
            char* next = nullptr;
            double v = strtod(p, &next);
            if (next != p) {
                if (count >= cap) return -1;
                out[count++] = v;
                p = next;
                continue;
            }
        }
        ++p;
    }
    return count;
}

// Format rows x cols doubles as "%1.6e" values, space-separated, each row
// ending in a newline.  Returns the bytes written, or -1 on overflow.
int64_t hk_format_e(const double* v, int64_t rows, int64_t cols,
                    char* out, int64_t cap) {
    char* q = out;
    char* qend = out + cap;
    for (int64_t r = 0; r < rows; ++r) {
        for (int64_t c = 0; c < cols; ++c) {
            if (qend - q < 32) return -1;
            int len = snprintf(q, 32, "%1.6e", v[r * cols + c]);
            q += len;
            *q++ = (c + 1 == cols) ? '\n' : ' ';
        }
    }
    return q - out;
}

// Format rows x cols int32 values as "%d" rows (the VTK CELLS lines).
int64_t hk_format_i(const int32_t* v, int64_t rows, int64_t cols,
                    char* out, int64_t cap) {
    char* q = out;
    char* qend = out + cap;
    for (int64_t r = 0; r < rows; ++r) {
        for (int64_t c = 0; c < cols; ++c) {
            if (qend - q < 16) return -1;
            int len = snprintf(q, 16, "%d", v[r * cols + c]);
            q += len;
            *q++ = (c + 1 == cols) ? '\n' : ' ';
        }
    }
    return q - out;
}

}  // extern "C"
