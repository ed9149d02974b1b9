// Native journal-frame scanner + zlib-compatible CRC32.
//
// The runtime analogue of the reference's native storage engines (its
// metastore rides RocksDB's C++ via JNI): recovery-scanning a journal in
// Python costs a bytes allocation + two attribute lookups + a zlib call
// PER FRAME; this scanner validates [u32 len][u32 crc32][body] framing
// over one mmap'd buffer at memory bandwidth with zero per-frame
// allocations, returning frame offsets for the (semantic) msgpack decode
// to consume. Shared by journal/format.py and journal/raft.py — both
// write the same frame layout.
//
// Built on demand by build.py (g++ -O3); loaded via ctypes, so every
// entry point is extern "C" with POD-only signatures.

#include <cstddef>
#include <cstdint>

namespace {

// zlib CRC32 (poly 0xEDB88320, reflected), slice-by-8. Tables build in
// a static initializer (runs once at dlopen, before any ctypes call can
// race it — lazy bool-guarded init would be UB under the concurrent
// first calls the GIL-releasing ctypes boundary allows).
uint32_t g_tab[8][256];

struct TabInit {
    TabInit() {
        for (uint32_t i = 0; i < 256; ++i) {
            uint32_t c = i;
            for (int k = 0; k < 8; ++k)
                c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
            g_tab[0][i] = c;
        }
        for (uint32_t i = 0; i < 256; ++i)
            for (int s = 1; s < 8; ++s)
                g_tab[s][i] = g_tab[0][g_tab[s - 1][i] & 0xFFu] ^
                              (g_tab[s - 1][i] >> 8);
    }
};
const TabInit g_tab_init;

inline uint32_t crc32_impl(const uint8_t* p, size_t n, uint32_t seed) {
    uint32_t c = ~seed;
    while (n >= 8) {
        // byte-wise 64-bit gather keeps this endian/alignment safe
        uint32_t lo = static_cast<uint32_t>(p[0]) |
                      (static_cast<uint32_t>(p[1]) << 8) |
                      (static_cast<uint32_t>(p[2]) << 16) |
                      (static_cast<uint32_t>(p[3]) << 24);
        uint32_t hi = static_cast<uint32_t>(p[4]) |
                      (static_cast<uint32_t>(p[5]) << 8) |
                      (static_cast<uint32_t>(p[6]) << 16) |
                      (static_cast<uint32_t>(p[7]) << 24);
        c ^= lo;
        c = g_tab[7][c & 0xFF] ^ g_tab[6][(c >> 8) & 0xFF] ^
            g_tab[5][(c >> 16) & 0xFF] ^ g_tab[4][c >> 24] ^
            g_tab[3][hi & 0xFF] ^ g_tab[2][(hi >> 8) & 0xFF] ^
            g_tab[1][(hi >> 16) & 0xFF] ^ g_tab[0][hi >> 24];
        p += 8;
        n -= 8;
    }
    while (n--) c = g_tab[0][(c ^ *p++) & 0xFF] ^ (c >> 8);
    return ~c;
}

inline uint32_t read_u32le(const uint8_t* p) {
    return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
           (static_cast<uint32_t>(p[2]) << 16) |
           (static_cast<uint32_t>(p[3]) << 24);
}

}  // namespace

extern "C" {

uint32_t atpu_crc32(const uint8_t* p, size_t n, uint32_t seed) {
    return crc32_impl(p, n, seed);
}

// Scan frames in buf[start_off:len]. For each valid frame i < cap,
// write the BODY offset into offsets[i] and body length into
// lengths[i]. Stops at the first torn/invalid frame (short header,
// length==0 zero-padding guard, body past EOF, or CRC mismatch) —
// everything after a torn frame is unreachable on restart, matching
// the Python scanners. Returns the number of valid frames; *end_off
// gets the byte offset one past the last valid frame (resume point
// for chunked calls / truncation point for torn tails).
size_t atpu_scan_frames(const uint8_t* buf, size_t len, size_t start_off,
                        uint64_t* offsets, uint32_t* lengths, size_t cap,
                        uint64_t* end_off) {
    size_t off = start_off, count = 0;
    while (count < cap && off + 8 <= len) {
        uint32_t flen = read_u32le(buf + off);
        uint32_t fcrc = read_u32le(buf + off + 4);
        if (flen == 0) break;                    // zero padding
        if (off + 8 + flen > len) break;         // torn body
        if (crc32_impl(buf + off + 8, flen, 0) != fcrc) break;
        offsets[count] = off + 8;
        lengths[count] = flen;
        ++count;
        off += 8 + static_cast<size_t>(flen);
    }
    if (end_off) *end_off = off;
    return count;
}

// Touch one byte per page so a later sequential consumer never
// page-fault-stalls (loader pre-fault; GIL-free by construction).
uint64_t atpu_prefault(const uint8_t* buf, size_t len, size_t stride) {
    if (stride == 0) stride = 4096;
    uint64_t acc = 0;
    for (size_t i = 0; i < len; i += stride) acc += buf[i];
    if (len) acc += buf[len - 1];
    return acc;
}

}  // extern "C"
