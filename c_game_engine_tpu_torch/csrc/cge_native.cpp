// cge_native — host-side native runtime components (the port's own copy of
// native/cge_native.cpp, built by c_game_engine_tpu_torch/native.py).
//
// The reference engine's runtime is C11 + C++ dependencies (Jolt physics,
// zlib asset pipeline; SURVEY.md §2.9). The port keeps the compute path in
// PyTorch and CUDA, and provides native equivalents for the host-side
// pieces:
//
//   1. .g* asset container codec (23-byte header + gzip stream,
//      engine/src/assets/AssetReader.c:150-257) and the CGAS action-stream
//      codec (core/actions_io.py writes the same bytes in Python).
//   2. An independent double-precision capsule character-controller oracle
//      (collide-and-slide vs a triangle soup) used by the test suite to
//      cross-validate physics/character.py::update_character.
//
// Exposed as a plain C ABI for ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// asset container
// ---------------------------------------------------------------------------

// Reads a .g* container. Returns 0 on success. Caller frees *out_data with
// cge_free.
int cge_read_asset(const char *path, uint8_t *out_type, uint8_t *out_type_version,
                   uint8_t **out_data, uint64_t *out_size) {
    FILE *f = fopen(path, "rb");
    if (!f) return -1;
    uint8_t header[23];
    if (fread(header, 1, 23, f) != 23) { fclose(f); return -2; }
    uint32_t magic;
    memcpy(&magic, header, 4);
    if (magic != 0x454D4147u) { fclose(f); return -3; }
    if (header[4] != 2) { fclose(f); return -4; }
    *out_type = header[5];
    *out_type_version = header[6];
    uint64_t dsize, csize;
    memcpy(&dsize, header + 7, 8);
    memcpy(&csize, header + 15, 8);
    // validate the untrusted header against the actual file size (the
    // reference checks fileSize - ASSET_HEADER_SIZE == compressedSize,
    // AssetReader.c) and bound the decompressed allocation
    if (fseek(f, 0, SEEK_END) != 0) { fclose(f); return -9; }
    long fsize = ftell(f);
    if (fsize < 23 || csize != (uint64_t)(fsize - 23)) { fclose(f); return -9; }
    if (fseek(f, 23, SEEK_SET) != 0) { fclose(f); return -9; }
    const uint64_t MAX_DSIZE = 1ull << 32;  // 4 GiB cap on asset payloads
    if (dsize > MAX_DSIZE || csize > (uInt)-1) { fclose(f); return -10; }
    std::vector<uint8_t> comp(csize);
    if (fread(comp.data(), 1, csize, f) != csize) { fclose(f); return -5; }
    fclose(f);

    uint8_t *out = (uint8_t *)malloc(dsize ? dsize : 1);
    if (!out) return -6;
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    // 15 + 16: gzip wrapper
    if (inflateInit2(&zs, 15 + 16) != Z_OK) { free(out); return -7; }
    zs.next_in = comp.data();
    zs.avail_in = (uInt)csize;
    zs.next_out = out;
    // dsize <= 4 GiB can still exceed uInt; feed the output in chunks
    uint64_t produced = 0;
    int rc = Z_OK;
    while (produced < dsize || produced == 0) {
        uint64_t room = dsize - produced;
        uInt chunk = room > 0x40000000u ? 0x40000000u : (uInt)room;
        zs.next_out = out + produced;
        zs.avail_out = chunk;
        rc = inflate(&zs, Z_FINISH);
        produced = zs.total_out;
        if (rc == Z_STREAM_END || (rc != Z_OK && rc != Z_BUF_ERROR)) break;
        if (rc == Z_BUF_ERROR && zs.avail_out != 0) break;  // input exhausted
        if (dsize == 0) break;
    }
    inflateEnd(&zs);
    if (rc != Z_STREAM_END || zs.total_out != dsize) { free(out); return -8; }
    *out_data = out;
    *out_size = dsize;
    return 0;
}

// Writes a .g* container (gzip level 6). Returns 0 on success.
int cge_write_asset(const char *path, uint8_t type, uint8_t type_version,
                    const uint8_t *data, uint64_t size) {
    if (size > (uInt)-1) return -5;  // single-shot deflate; assets are small
    uLongf bound = compressBound((uLong)size) + 32;
    std::vector<uint8_t> comp(bound);
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    if (deflateInit2(&zs, 6, Z_DEFLATED, 15 + 16, 8, Z_DEFAULT_STRATEGY) != Z_OK)
        return -1;
    zs.next_in = (Bytef *)data;
    zs.avail_in = (uInt)size;
    zs.next_out = comp.data();
    zs.avail_out = (uInt)bound;
    if (deflate(&zs, Z_FINISH) != Z_STREAM_END) { deflateEnd(&zs); return -2; }
    uint64_t csize = zs.total_out;
    deflateEnd(&zs);

    FILE *f = fopen(path, "wb");
    if (!f) return -3;
    uint8_t header[23];
    uint32_t magic = 0x454D4147u;
    memcpy(header, &magic, 4);
    header[4] = 2;
    header[5] = type;
    header[6] = type_version;
    memcpy(header + 7, &size, 8);
    memcpy(header + 15, &csize, 8);
    bool ok = fwrite(header, 1, 23, f) == 23 &&
              fwrite(comp.data(), 1, csize, f) == csize;
    ok = fclose(f) == 0 && ok;
    return ok ? 0 : -4;
}

void cge_free(void *p) { free(p); }

// ---------------------------------------------------------------------------
// batch action-stream recorder / replayer
// ---------------------------------------------------------------------------
//
// The reference's input path is the SDL event queue copied across the
// physics-thread boundary (PhysicsThread.c:45-53, Input.c). The batch
// framework replaces live input with scripted action streams
// (core/actions.py); this codec stores those streams as a compact gzip
// container so long multi-thousand-env recordings replay byte-exactly:
//
//   header (32 B LE): magic 'CGAS' u32 | version u8 | n_buttons u8 |
//     reserved u16 | batch u32 | n_ticks u32 | raw_size u64 | comp_size u64
//   gzip payload: move [T*B*2] f32, look [T*B*2] f32,
//     buttons [T*B] u16 bitmask (bit i = Button i held this tick)

static const uint32_t CGAS_MAGIC = 0x53414743u;  // "CGAS"

int cge_actions_write(const char *path, uint32_t batch, uint32_t n_ticks,
                      uint8_t n_buttons, const float *move, const float *look,
                      const uint8_t *buttons) {
    if (n_buttons > 16) return -1;
    const uint64_t tb = (uint64_t)batch * n_ticks;
    const uint64_t raw_size = tb * 2 * 4 * 2 + tb * 2;  // move+look f32, mask u16
    std::vector<uint8_t> raw(raw_size);
    memcpy(raw.data(), move, tb * 8);
    memcpy(raw.data() + tb * 8, look, tb * 8);
    uint16_t *mask = (uint16_t *)(raw.data() + tb * 16);
    for (uint64_t i = 0; i < tb; i++) {
        uint16_t m = 0;
        for (uint8_t b = 0; b < n_buttons; b++)
            if (buttons[i * n_buttons + b]) m |= (uint16_t)(1u << b);
        mask[i] = m;
    }
    if (raw_size > (uInt)-1) return -2;
    uLongf bound = compressBound((uLong)raw_size) + 32;
    std::vector<uint8_t> comp(bound);
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    if (deflateInit2(&zs, 6, Z_DEFLATED, 15 + 16, 8, Z_DEFAULT_STRATEGY) != Z_OK)
        return -3;
    zs.next_in = raw.data();
    zs.avail_in = (uInt)raw_size;
    zs.next_out = comp.data();
    zs.avail_out = (uInt)bound;
    if (deflate(&zs, Z_FINISH) != Z_STREAM_END) { deflateEnd(&zs); return -4; }
    uint64_t comp_size = zs.total_out;
    deflateEnd(&zs);

    FILE *f = fopen(path, "wb");
    if (!f) return -5;
    uint8_t header[32];
    memcpy(header, &CGAS_MAGIC, 4);
    header[4] = 1;
    header[5] = n_buttons;
    header[6] = header[7] = 0;
    memcpy(header + 8, &batch, 4);
    memcpy(header + 12, &n_ticks, 4);
    memcpy(header + 16, &raw_size, 8);
    memcpy(header + 24, &comp_size, 8);
    bool ok = fwrite(header, 1, 32, f) == 32 &&
              fwrite(comp.data(), 1, comp_size, f) == comp_size;
    ok = fclose(f) == 0 && ok;
    return ok ? 0 : -6;
}

// Outputs are malloc'd; caller frees each with cge_free. buttons comes back
// expanded to [T*B*n_buttons] u8.
int cge_actions_read(const char *path, uint32_t *batch, uint32_t *n_ticks,
                     uint8_t *n_buttons, float **out_move, float **out_look,
                     uint8_t **out_buttons) {
    FILE *f = fopen(path, "rb");
    if (!f) return -1;
    uint8_t header[32];
    if (fread(header, 1, 32, f) != 32) { fclose(f); return -2; }
    uint32_t magic;
    memcpy(&magic, header, 4);
    if (magic != CGAS_MAGIC || header[4] != 1) { fclose(f); return -3; }
    uint8_t nb = header[5];
    uint32_t B, T;
    memcpy(&B, header + 8, 4);
    memcpy(&T, header + 12, 4);
    uint64_t raw_size, comp_size;
    memcpy(&raw_size, header + 16, 8);
    memcpy(&comp_size, header + 24, 8);
    const uint64_t tb = (uint64_t)B * T;
    // validate the untrusted header: sizes consistent and within bounds
    if (nb > 16 || raw_size != tb * 18 || raw_size > (1ull << 32)) {
        fclose(f);
        return -4;
    }
    if (fseek(f, 0, SEEK_END) != 0 ||
        (uint64_t)ftell(f) != 32 + comp_size ||
        fseek(f, 32, SEEK_SET) != 0 || comp_size > (uInt)-1) {
        fclose(f);
        return -4;
    }
    std::vector<uint8_t> comp(comp_size);
    if (fread(comp.data(), 1, comp_size, f) != comp_size) { fclose(f); return -5; }
    fclose(f);

    std::vector<uint8_t> raw(raw_size);
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, 15 + 16) != Z_OK) return -6;
    zs.next_in = comp.data();
    zs.avail_in = (uInt)comp_size;
    zs.next_out = raw.data();
    zs.avail_out = (uInt)raw_size;
    int rc = inflate(&zs, Z_FINISH);
    bool ok = rc == Z_STREAM_END && zs.total_out == raw_size;
    inflateEnd(&zs);
    if (!ok) return -7;

    float *mv = (float *)malloc(tb ? tb * 8 : 1);
    float *lk = (float *)malloc(tb ? tb * 8 : 1);
    uint8_t *bt = (uint8_t *)malloc(tb && nb ? tb * nb : 1);
    if (!mv || !lk || !bt) { free(mv); free(lk); free(bt); return -8; }
    memcpy(mv, raw.data(), tb * 8);
    memcpy(lk, raw.data() + tb * 8, tb * 8);
    const uint16_t *mask = (const uint16_t *)(raw.data() + tb * 16);
    for (uint64_t i = 0; i < tb; i++)
        for (uint8_t b = 0; b < nb; b++)
            bt[i * nb + b] = (mask[i] >> b) & 1u;
    *batch = B;
    *n_ticks = T;
    *n_buttons = nb;
    *out_move = mv;
    *out_look = lk;
    *out_buttons = bt;
    return 0;
}

// ---------------------------------------------------------------------------
// character controller oracle
// ---------------------------------------------------------------------------

struct V3 {
    double x, y, z;
};
static inline V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static inline V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
static inline V3 mul(V3 a, double s) { return {a.x * s, a.y * s, a.z * s}; }
static inline double dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
static inline V3 cross(V3 a, V3 b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
static inline double len(V3 a) { return std::sqrt(dot(a, a)); }

static V3 closest_on_tri(V3 p, V3 a, V3 b, V3 c) {
    V3 ab = sub(b, a), ac = sub(c, a), ap = sub(p, a);
    double d1 = dot(ab, ap), d2 = dot(ac, ap);
    if (d1 <= 0 && d2 <= 0) return a;
    V3 bp = sub(p, b);
    double d3 = dot(ab, bp), d4 = dot(ac, bp);
    if (d3 >= 0 && d4 <= d3) return b;
    double vc = d1 * d4 - d3 * d2;
    if (vc <= 0 && d1 >= 0 && d3 <= 0) {
        double v = d1 / (d1 - d3);
        return add(a, mul(ab, v));
    }
    V3 cp = sub(p, c);
    double d5 = dot(ab, cp), d6 = dot(ac, cp);
    if (d6 >= 0 && d5 <= d6) return c;
    double vb = d5 * d2 - d1 * d6;
    if (vb <= 0 && d2 >= 0 && d6 <= 0) {
        double w = d2 / (d2 - d6);
        return add(a, mul(ac, w));
    }
    double va = d3 * d6 - d5 * d4;
    if (va <= 0 && (d4 - d3) >= 0 && (d5 - d6) >= 0) {
        double w = (d4 - d3) / ((d4 - d3) + (d5 - d6));
        return add(b, mul(sub(c, b), w));
    }
    double denom = 1.0 / (va + vb + vc);
    double v = vb * denom, w = vc * denom;
    return add(a, add(mul(ab, v), mul(ac, w)));
}

static V3 closest_on_seg(V3 p, V3 s0, V3 s1) {
    V3 d = sub(s1, s0);
    double dd = dot(d, d);
    double t = dd > 1e-30 ? dot(sub(p, s0), d) / dd : 0.0;
    t = std::clamp(t, 0.0, 1.0);
    return add(s0, mul(d, t));
}

// One collide-and-slide step of the capsule character (r=0.2 halfH=0.25,
// max slope 50 deg, 4 resolve iterations, stick-to-floor 0.25).
// tris: ntris * 9 doubles. pos/vel: 3 doubles, updated in place.
// Returns 1 if grounded after the step.
int cge_character_step(const double *tris, int64_t ntris, double *pos,
                       double *vel, double dt, int was_on_ground) {
    const double R = 0.2, HH = 0.25, MAX_SLOPE_COS = 0.6427876097;
    V3 p = {pos[0] + vel[0] * dt, pos[1] + vel[1] * dt, pos[2] + vel[2] * dt};
    V3 v = {vel[0], vel[1], vel[2]};
    bool grounded = false;

    auto resolve = [&](V3 &p, V3 &v, bool &grounded) {
        for (int it = 0; it < 4; it++) {
            double best_d = -1e30;
            V3 best_n = {0, 1, 0};
            for (int64_t t = 0; t < ntris; t++) {
                V3 a = {tris[t * 9 + 0], tris[t * 9 + 1], tris[t * 9 + 2]};
                V3 b = {tris[t * 9 + 3], tris[t * 9 + 4], tris[t * 9 + 5]};
                V3 c = {tris[t * 9 + 6], tris[t * 9 + 7], tris[t * 9 + 8]};
                V3 s0 = {p.x, p.y - HH, p.z}, s1 = {p.x, p.y + HH, p.z};
                // alternating projection (3 iterations, as in geometry.py)
                V3 q = closest_on_tri({p.x, p.y, p.z}, a, b, c);
                V3 ps = s0;
                for (int k = 0; k < 3; k++) {
                    ps = closest_on_seg(q, s0, s1);
                    q = closest_on_tri(ps, a, b, c);
                }
                V3 delta = sub(ps, q);
                double dist = len(delta);
                V3 fn = cross(sub(b, a), sub(c, a));
                double fl = len(fn);
                if (fl < 1e-12) continue;
                fn = mul(fn, 1.0 / fl);
                double side = dot(sub({p.x, p.y, p.z}, a), fn) >= 0 ? 1.0 : -1.0;
                V3 n;
                if (dist > 1e-6) {
                    n = mul(delta, 1.0 / dist);
                    double flip = dot(n, fn) * side >= 0 ? 1.0 : -1.0;
                    n = mul(n, flip);
                } else {
                    n = mul(fn, side);
                }
                double depth = R - dot(delta, n);
                if (depth > best_d) {
                    best_d = depth;
                    best_n = n;
                }
            }
            if (best_d > -0.01) {
                if (best_d > 0) p = add(p, mul(best_n, best_d));
                double vn = dot(v, best_n);
                if (vn < 0) v = sub(v, mul(best_n, vn));
                if (best_n.y >= MAX_SLOPE_COS) grounded = true;
            }
        }
    };

    resolve(p, v, grounded);
    if (was_on_ground && !grounded && v.y <= 1e-4) {
        V3 p2 = {p.x, p.y - 0.25, p.z};
        V3 v2 = v;
        bool g2 = false;
        resolve(p2, v2, g2);
        if (g2) {
            p = p2;
            v = v2;
            grounded = true;
        }
    }
    pos[0] = p.x;
    pos[1] = p.y;
    pos[2] = p.z;
    vel[0] = v.x;
    vel[1] = v.y;
    vel[2] = v.z;
    return grounded ? 1 : 0;
}

}  // extern "C"
