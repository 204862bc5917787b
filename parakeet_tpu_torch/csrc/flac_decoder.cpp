// Minimal native FLAC decoder (from-scratch, spec-complete for the subset
// every mainstream encoder emits: CONSTANT / VERBATIM / FIXED(0-4) /
// LPC(1-32) subframes, Rice partitions (methods 0/1 + escapes), wasted
// bits, all stereo decorrelation modes, 8/12/16/20/24/32-bit samples.
//
// Gives parakeet-tpu the reference's dr_flac capability (audio_io.cpp uses
// dr_flac) without vendoring third-party code. Exposed via the same C ABI
// loader as parakeet_native.cpp.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

class BitReader {
  public:
    BitReader(const uint8_t* data, size_t len) : data_(data), len_(len) {}

    bool ok() const { return !error_; }
    size_t byte_pos() const { return pos_; }

    // Read up to 32 bits MSB-first.
    uint32_t bits(int n) {
        uint32_t v = 0;
        for (int i = 0; i < n; ++i) {
            if (pos_ >= len_) { error_ = true; return 0; }
            v = (v << 1) | ((data_[pos_] >> (7 - bit_)) & 1u);
            if (++bit_ == 8) { bit_ = 0; ++pos_; }
        }
        return v;
    }

    uint64_t bits64(int n) {
        uint64_t v = 0;
        if (n > 32) { v = bits(n - 32); n = 32; }
        return (v << n) | bits(n);
    }

    // Sign-extended read, up to 64 bits (side channels of 32-bit streams
    // need 33-bit values).
    int64_t signed_bits(int n) {
        uint64_t v = bits64(n);
        if (n == 0) return 0;
        if (n < 64 && (v & (1ull << (n - 1))))
            return static_cast<int64_t>(v | (~0ull << n));
        return static_cast<int64_t>(v);
    }

    // Unary: count zero bits until a 1.
    uint32_t unary() {
        uint32_t c = 0;
        while (ok()) {
            if (bits(1)) return c;
            if (++c > 1u << 24) { error_ = true; return 0; }  // corrupt stream guard
        }
        return 0;
    }

    void align_byte() {
        if (bit_) { bit_ = 0; ++pos_; }
    }

    void skip_bytes(size_t n) {
        pos_ += n;
        if (pos_ > len_) error_ = true;
    }

    bool at_end() const { return pos_ >= len_; }

  private:
    const uint8_t* data_;
    size_t len_;
    size_t pos_ = 0;
    int bit_ = 0;
    bool error_ = false;
};

struct StreamInfo {
    uint32_t sample_rate = 0;
    int channels = 0;
    int bits_per_sample = 0;
    uint64_t total_samples = 0;
};

// Rice residual into res[order .. block_size).
bool read_residual(BitReader& br, int order, int block_size, std::vector<int64_t>& res) {
    const uint32_t method = br.bits(2);
    if (method > 1) return false;
    const int param_bits = method == 0 ? 4 : 5;
    const uint32_t escape = method == 0 ? 15 : 31;
    const uint32_t partition_order = br.bits(4);
    const int partitions = 1 << partition_order;
    if (block_size % partitions != 0) return false;
    int idx = order;
    for (int p = 0; p < partitions; ++p) {
        int count = block_size >> partition_order;
        if (p == 0) count -= order;
        if (count < 0) return false;
        const uint32_t param = br.bits(param_bits);
        if (param == escape) {
            const uint32_t raw_bits = br.bits(5);
            for (int i = 0; i < count; ++i) res[idx++] = raw_bits ? br.signed_bits(raw_bits) : 0;
        } else {
            for (int i = 0; i < count; ++i) {
                const uint32_t q = br.unary();
                const uint32_t r = param ? br.bits(param) : 0;
                const uint64_t u = (static_cast<uint64_t>(q) << param) | r;
                res[idx++] = static_cast<int64_t>(u >> 1) ^ -static_cast<int64_t>(u & 1);
            }
        }
        if (!br.ok()) return false;
    }
    return idx == block_size;
}

bool decode_subframe(BitReader& br, int block_size, int bps, std::vector<int64_t>& out) {
    if (br.bits(1) != 0) return false;  // padding bit
    const uint32_t type = br.bits(6);
    int wasted = 0;
    if (br.bits(1)) wasted = static_cast<int>(br.unary()) + 1;
    bps -= wasted;
    if (bps <= 0 || bps > 33) return false;

    out.assign(block_size, 0);

    if (type == 0) {  // CONSTANT
        const int64_t v = br.signed_bits(bps);
        for (int i = 0; i < block_size; ++i) out[i] = v;
    } else if (type == 1) {  // VERBATIM
        for (int i = 0; i < block_size; ++i) out[i] = br.signed_bits(bps);
    } else if (type >= 8 && type <= 12) {  // FIXED, order 0-4
        const int order = type - 8;
        for (int i = 0; i < order; ++i) out[i] = br.signed_bits(bps);
        if (!read_residual(br, order, block_size, out)) return false;
        switch (order) {
            case 0: break;
            case 1:
                for (int i = 1; i < block_size; ++i) out[i] += out[i - 1];
                break;
            case 2:
                for (int i = 2; i < block_size; ++i) out[i] += 2 * out[i - 1] - out[i - 2];
                break;
            case 3:
                for (int i = 3; i < block_size; ++i)
                    out[i] += 3 * out[i - 1] - 3 * out[i - 2] + out[i - 3];
                break;
            case 4:
                for (int i = 4; i < block_size; ++i)
                    out[i] += 4 * out[i - 1] - 6 * out[i - 2] + 4 * out[i - 3] - out[i - 4];
                break;
        }
    } else if (type >= 32) {  // LPC, order 1-32
        const int order = static_cast<int>(type) - 31;
        for (int i = 0; i < order; ++i) out[i] = br.signed_bits(bps);
        const uint32_t precision = br.bits(4) + 1;
        if (precision == 16) return false;  // 0b1111 is invalid
        const int shift = static_cast<int>(br.signed_bits(5));
        if (shift < 0) return false;
        std::vector<int64_t> coef(order);
        for (int i = 0; i < order; ++i) coef[i] = br.signed_bits(precision);
        if (!read_residual(br, order, block_size, out)) return false;
        for (int i = order; i < block_size; ++i) {
            int64_t acc = 0;
            for (int j = 0; j < order; ++j) acc += coef[j] * out[i - 1 - j];
            out[i] += acc >> shift;
        }
    } else {
        return false;  // reserved type
    }

    if (wasted) {
        for (int i = 0; i < block_size; ++i) out[i] <<= wasted;
    }
    return br.ok();
}

// Skip a UTF-8-style coded frame/sample number.
bool skip_coded_number(BitReader& br) {
    uint32_t first = br.bits(8);
    int extra = 0;
    for (uint32_t mask = 0x80; first & mask; mask >>= 1) ++extra;
    if (extra == 1 || extra > 7) return false;  // invalid lead byte
    if (extra) br.skip_bytes(extra - 1);
    return br.ok();
}

}  // namespace

extern "C" {

// Decode FLAC to interleaved float32. Returns 0 on success.
// On success *out is malloc'd (caller frees with pk_free), *out_frames and
// *out_channels / *out_sample_rate are set.
int pk_flac_decode(const uint8_t* data, size_t len, float** out,
                   int64_t* out_frames, int* out_channels, int* out_sample_rate) {
    *out = nullptr;
    *out_frames = 0;
    if (len < 8 || std::memcmp(data, "fLaC", 4) != 0) return 1;

    BitReader br(data, len);
    br.skip_bytes(4);

    StreamInfo info;
    bool last = false, have_info = false;
    while (!last && br.ok()) {
        const uint32_t header = br.bits(8);
        last = header & 0x80;
        const uint32_t type = header & 0x7F;
        const uint32_t length = br.bits(24);
        if (type == 0 && length >= 34) {  // STREAMINFO
            br.bits(16);  // min block size
            br.bits(16);  // max block size
            br.bits(24);  // min frame size
            br.bits(24);  // max frame size
            info.sample_rate = br.bits(20);
            info.channels = static_cast<int>(br.bits(3)) + 1;
            info.bits_per_sample = static_cast<int>(br.bits(5)) + 1;
            info.total_samples = br.bits64(36);
            br.skip_bytes(16);          // md5
            br.skip_bytes(length - 34);  // any extension
            have_info = true;
        } else {
            br.skip_bytes(length);
        }
    }
    if (!have_info || !br.ok() || info.channels < 1 || info.channels > 8) return 2;

    std::vector<float> pcm;
    if (info.total_samples) pcm.reserve(info.total_samples * info.channels);

    std::vector<std::vector<int64_t>> ch(info.channels);
    const float scale = 1.0f / static_cast<float>(1ull << (info.bits_per_sample - 1));

    while (br.ok() && !br.at_end()) {
        // frame sync
        const uint32_t sync = br.bits(14);
        if (!br.ok()) break;  // clean EOF
        if (sync != 0x3FFE) return 3;
        br.bits(1);  // reserved
        br.bits(1);  // blocking strategy
        const uint32_t bs_code = br.bits(4);
        const uint32_t sr_code = br.bits(4);
        const uint32_t ch_code = br.bits(4);
        const uint32_t ss_code = br.bits(3);
        br.bits(1);  // reserved

        if (!skip_coded_number(br)) return 4;

        int block_size;
        switch (bs_code) {
            case 0: return 5;
            case 1: block_size = 192; break;
            case 6: block_size = static_cast<int>(br.bits(8)) + 1; break;
            case 7: block_size = static_cast<int>(br.bits(16)) + 1; break;
            default:
                block_size = (bs_code <= 5) ? (576 << (bs_code - 2)) : (256 << (bs_code - 8));
        }
        if (sr_code == 12) br.bits(8);
        else if (sr_code == 13 || sr_code == 14) br.bits(16);

        int bps = info.bits_per_sample;
        switch (ss_code) {
            case 1: bps = 8; break;
            case 2: bps = 12; break;
            case 4: bps = 16; break;
            case 5: bps = 20; break;
            case 6: bps = 24; break;
            case 7: bps = 32; break;
        }
        br.bits(8);  // CRC-8 (not verified)

        int nch = info.channels;
        int side_channel = -1;  // which channel is the +1-bit side channel
        if (ch_code <= 7) {
            nch = static_cast<int>(ch_code) + 1;
            if (nch != info.channels) return 6;
        } else if (ch_code == 8) {  // left/side
            nch = 2; side_channel = 1;
        } else if (ch_code == 9) {  // right/side
            nch = 2; side_channel = 0;
        } else if (ch_code == 10) {  // mid/side
            nch = 2; side_channel = 1;
        } else {
            return 7;
        }
        if (nch != info.channels) return 6;

        for (int c = 0; c < nch; ++c) {
            const int sub_bps = bps + (c == side_channel ? 1 : 0);
            if (!decode_subframe(br, block_size, sub_bps, ch[c])) return 8;
        }
        br.align_byte();
        br.bits(16);  // CRC-16 (not verified)
        if (!br.ok()) return 9;

        // stereo decorrelation
        if (ch_code == 8) {  // left/side: R = L - S
            for (int i = 0; i < block_size; ++i) ch[1][i] = ch[0][i] - ch[1][i];
        } else if (ch_code == 9) {  // right/side: L = S + R
            for (int i = 0; i < block_size; ++i) {
                const int64_t s = ch[0][i];
                ch[0][i] = s + ch[1][i];
            }
        } else if (ch_code == 10) {  // mid/side
            for (int i = 0; i < block_size; ++i) {
                const int64_t s = ch[1][i];
                int64_t m = (ch[0][i] << 1) | (s & 1);
                ch[0][i] = (m + s) >> 1;
                ch[1][i] = (m - s) >> 1;
            }
        }

        for (int i = 0; i < block_size; ++i)
            for (int c = 0; c < nch; ++c)
                pcm.push_back(static_cast<float>(ch[c][i]) * scale);

        if (info.total_samples &&
            pcm.size() >= info.total_samples * static_cast<uint64_t>(info.channels))
            break;
    }

    if (info.total_samples) {
        const size_t want = static_cast<size_t>(info.total_samples) * info.channels;
        if (pcm.size() > want) pcm.resize(want);
    }

    float* buf = static_cast<float*>(std::malloc(pcm.size() * sizeof(float)));
    if (!buf) return 10;
    std::memcpy(buf, pcm.data(), pcm.size() * sizeof(float));
    *out = buf;
    *out_frames = static_cast<int64_t>(pcm.size() / info.channels);
    *out_channels = info.channels;
    *out_sample_rate = static_cast<int>(info.sample_rate);
    return 0;
}

void pk_free(void* p) { std::free(p); }

}  // extern "C"
