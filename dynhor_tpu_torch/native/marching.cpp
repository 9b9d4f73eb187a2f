// Marching-tetrahedra isosurface extraction (native host runtime).
//
// The TPU evaluates the SDF grid; this C++ engine turns it into a mesh.
// It replaces the numpy implementation in dynhor_tpu/neus/extract.py for
// large grids (the unique-edge dedup dominates there); results are
// identical (same 6-tet cube split, same per-case tables, same edge
// interpolation), covered by an equivalence test.
//
// Build: g++ -O3 -march=native -shared -fPIC marching.cpp -o libmarching.so
// ABI (ctypes):
//   mt_extract(sdf, nx, ny, nz, origin[3], spacing[3],
//              &verts_ptr, &n_verts, &faces_ptr, &n_faces) -> int (0 ok)
//   mt_free(verts_ptr, faces_ptr)
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

// Cube corner offsets, binary order (bit2=x, bit1=y, bit0=z) — matches
// extract.py _CORNERS.
const int CORNERS[8][3] = {
    {0, 0, 0}, {0, 0, 1}, {0, 1, 0}, {0, 1, 1},
    {1, 0, 0}, {1, 0, 1}, {1, 1, 0}, {1, 1, 1},
};
// 6-tetra decomposition sharing the 0-7 diagonal — matches extract.py _TETS.
const int TETS[6][4] = {
    {0, 5, 1, 7}, {0, 1, 3, 7}, {0, 3, 2, 7},
    {0, 2, 6, 7}, {0, 6, 4, 7}, {0, 4, 5, 7},
};
// Per-case triangles as (corner_i, corner_j) edge pairs — matches
// extract.py _tet_triangles' E table.  -1 terminates.
const int CASES[16][13] = {
    {-1},
    {0, 1, 0, 2, 0, 3, -1},
    {1, 0, 1, 3, 1, 2, -1},
    {0, 2, 0, 3, 1, 3, 0, 2, 1, 3, 1, 2, -1},
    {2, 0, 2, 1, 2, 3, -1},
    {0, 1, 2, 1, 0, 3, 2, 1, 2, 3, 0, 3, -1},
    {1, 0, 2, 0, 1, 3, 2, 0, 2, 3, 1, 3, -1},
    {0, 3, 1, 3, 2, 3, -1},
    {3, 0, 3, 2, 3, 1, -1},
    {0, 1, 0, 2, 3, 2, 0, 1, 3, 2, 3, 1, -1},
    {1, 0, 3, 0, 1, 2, 3, 0, 3, 2, 1, 2, -1},
    {0, 2, 3, 2, 1, 2, -1},
    {2, 0, 3, 0, 2, 1, 3, 0, 3, 1, 2, 1, -1},
    {0, 1, 2, 1, 3, 1, -1},
    {1, 0, 3, 0, 2, 0, -1},
    {-1},
};

struct PairHash {
    size_t operator()(const std::pair<int64_t, int64_t>& p) const {
        return std::hash<int64_t>()(p.first * 1000003 ^ p.second);
    }
};

}  // namespace

extern "C" {

int mt_extract(const float* sdf, int nx, int ny, int nz,
               const float* origin, const float* spacing,
               float** out_verts, int64_t* out_n_verts,
               int32_t** out_faces, int64_t* out_n_faces) {
    auto val = [&](int64_t x, int64_t y, int64_t z) -> float {
        return sdf[(x * ny + y) * nz + z];
    };
    auto gid = [&](int64_t x, int64_t y, int64_t z) -> int64_t {
        return (x * ny + y) * nz + z;
    };

    std::unordered_map<std::pair<int64_t, int64_t>, int32_t, PairHash> edge_to_vid;
    std::vector<float> verts;
    std::vector<int32_t> faces;
    verts.reserve(1 << 16);
    faces.reserve(1 << 16);

    auto edge_vertex = [&](int64_t ga, int64_t gb) -> int32_t {
        // Canonical (sorted) edge key — matches extract.py's np.sort of
        // edge endpoints, so vertex positions agree exactly.
        int64_t lo = ga < gb ? ga : gb;
        int64_t hi = ga < gb ? gb : ga;
        auto key = std::make_pair(lo, hi);
        auto it = edge_to_vid.find(key);
        if (it != edge_to_vid.end()) return it->second;
        float va = sdf[lo], vb = sdf[hi];
        float denom = va - vb;
        if (denom > -1e-12f && denom < 1e-12f) denom = 1e-12f;
        float t = va / denom;
        t = t < 0.f ? 0.f : (t > 1.f ? 1.f : t);
        int64_t az = lo % nz, ay = (lo / nz) % ny, ax = lo / (int64_t)nz / ny;
        int64_t bz = hi % nz, by = (hi / nz) % ny, bx = hi / (int64_t)nz / ny;
        float px = (1.f - t) * ax + t * bx;
        float py = (1.f - t) * ay + t * by;
        float pz = (1.f - t) * az + t * bz;
        int32_t vid = (int32_t)(verts.size() / 3);
        verts.push_back(origin[0] + px * spacing[0]);
        verts.push_back(origin[1] + py * spacing[1]);
        verts.push_back(origin[2] + pz * spacing[2]);
        edge_to_vid.emplace(key, vid);
        return vid;
    };

    for (int64_t cx = 0; cx + 1 < nx; ++cx) {
        for (int64_t cy = 0; cy + 1 < ny; ++cy) {
            for (int64_t cz = 0; cz + 1 < nz; ++cz) {
                float v8[8];
                int64_t g8[8];
                bool all_in = true, all_out = true;
                for (int c = 0; c < 8; ++c) {
                    int64_t x = cx + CORNERS[c][0];
                    int64_t y = cy + CORNERS[c][1];
                    int64_t z = cz + CORNERS[c][2];
                    v8[c] = val(x, y, z);
                    g8[c] = gid(x, y, z);
                    if (v8[c] < 0.f) all_out = false; else all_in = false;
                }
                if (all_in || all_out) continue;
                for (int t = 0; t < 6; ++t) {
                    float tv[4];
                    int64_t tg[4];
                    int code = 0;
                    for (int k = 0; k < 4; ++k) {
                        tv[k] = v8[TETS[t][k]];
                        tg[k] = g8[TETS[t][k]];
                        if (tv[k] < 0.f) code |= (1 << k);
                    }
                    const int* e = CASES[code];
                    for (int k = 0; e[k] >= 0; k += 6) {
                        int32_t a = edge_vertex(tg[e[k + 0]], tg[e[k + 1]]);
                        int32_t b = edge_vertex(tg[e[k + 2]], tg[e[k + 3]]);
                        int32_t c = edge_vertex(tg[e[k + 4]], tg[e[k + 5]]);
                        faces.push_back(a);
                        faces.push_back(b);
                        faces.push_back(c);
                    }
                }
            }
        }
    }

    *out_n_verts = (int64_t)(verts.size() / 3);
    *out_n_faces = (int64_t)(faces.size() / 3);
    *out_verts = (float*)std::malloc(verts.size() * sizeof(float));
    *out_faces = (int32_t*)std::malloc(faces.size() * sizeof(int32_t));
    if ((!*out_verts && !verts.empty()) || (!*out_faces && !faces.empty())) return 1;
    if (!verts.empty()) std::memcpy(*out_verts, verts.data(), verts.size() * sizeof(float));
    if (!faces.empty()) std::memcpy(*out_faces, faces.data(), faces.size() * sizeof(int32_t));
    return 0;
}

void mt_free(float* verts, int32_t* faces) {
    std::free(verts);
    std::free(faces);
}

}  // extern "C"
