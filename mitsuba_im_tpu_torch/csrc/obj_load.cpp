// Native Wavefront OBJ parser (mitsuba_im_tpu/native/obj_loader.cpp,
// copied; built with g++ at first use by scene/mesh.py).
//
// Output semantics are those of the JAX package's pure-Python tokenizer:
// v/vn/vt records, polygon fan triangulation, negative indices, per-corner
// (v,vt,vn) deduplication in first-seen order.  Numbers are parsed with
// strtof, so values are the float32 nearest the text.
//
// C ABI (consumed via ctypes from scene/mesh.py):
//   mitpu_parse_obj(path, &handle, &n_verts, &n_tris, &has_n, &has_uv)
//   mitpu_obj_positions/normals/uvs/indices(handle) -> data pointers
//   mitpu_obj_free(handle)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct CornerKey {
    int32_t v, t, n;
    bool operator==(const CornerKey& o) const {
        return v == o.v && t == o.t && n == o.n;
    }
};

struct CornerHash {
    size_t operator()(const CornerKey& k) const {
        uint64_t h = (uint64_t)(uint32_t)k.v;
        h = h * 0x9E3779B97F4A7C15ull ^ (uint64_t)(uint32_t)k.t;
        h = h * 0x9E3779B97F4A7C15ull ^ (uint64_t)(uint32_t)k.n;
        h ^= h >> 31;
        return (size_t)h;
    }
};

struct ObjMesh {
    std::vector<float> positions;  // (V, 3)
    std::vector<float> normals;    // (V, 3) or empty
    std::vector<float> uvs;        // (V, 2) or empty
    std::vector<int32_t> indices;  // (T, 3)
    size_t n_norm_emitted = 0;
    size_t n_uv_emitted = 0;
};

inline const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    return p;
}

inline const char* next_line(const char* p, const char* end) {
    while (p < end && *p != '\n') ++p;
    return p < end ? p + 1 : end;
}

inline int32_t fix_index(int32_t idx, size_t n) {
    return idx > 0 ? idx - 1 : (int32_t)n + idx;
}

}  // namespace

extern "C" {

// returns 0 on success; fills an opaque handle
int32_t mitpu_parse_obj(const char* path, void** out_handle,
                        int64_t* n_verts, int64_t* n_tris,
                        int32_t* has_normals, int32_t* has_uvs) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::string buf;
    buf.resize((size_t)size);
    if (size > 0 && fread(&buf[0], 1, (size_t)size, f) != (size_t)size) {
        fclose(f);
        return -2;
    }
    fclose(f);

    std::vector<float> vs, vns, vts;  // raw records (x3 / x3 / x2)
    std::vector<CornerKey> corners;
    std::vector<std::pair<int64_t, int32_t>> faces;  // (start, count)

    const char* p = buf.data();
    const char* end = p + buf.size();
    while (p < end) {
        p = skip_ws(p, end);
        if (p >= end) break;
        if (p[0] == 'v' && p + 1 < end) {
            if (p[1] == ' ' || p[1] == '\t') {
                p += 2;
                for (int k = 0; k < 3; ++k) {
                    char* q;
                    vs.push_back(strtof(p, &q));
                    p = q;
                }
            } else if (p[1] == 'n' && p + 2 < end
                       && (p[2] == ' ' || p[2] == '\t')) {
                p += 3;
                for (int k = 0; k < 3; ++k) {
                    char* q;
                    vns.push_back(strtof(p, &q));
                    p = q;
                }
            } else if (p[1] == 't' && p + 2 < end
                       && (p[2] == ' ' || p[2] == '\t')) {
                p += 3;
                for (int k = 0; k < 2; ++k) {
                    char* q;
                    vts.push_back(strtof(p, &q));
                    p = q;
                }
            }
        } else if (p[0] == 'f' && p + 1 < end
                   && (p[1] == ' ' || p[1] == '\t')) {
            p += 2;
            int64_t start = (int64_t)corners.size();
            while (true) {
                p = skip_ws(p, end);
                if (p >= end || *p == '\n' || *p == '#') break;
                char* q;
                long vi = strtol(p, &q, 10);
                if (q == p) break;
                p = q;
                long ti = 0, ni = 0;
                if (p < end && *p == '/') {
                    ++p;
                    if (p < end && *p != '/') {
                        ti = strtol(p, &q, 10);
                        p = q;
                    }
                    if (p < end && *p == '/') {
                        ++p;
                        ni = strtol(p, &q, 10);
                        p = q;
                    }
                }
                corners.push_back({(int32_t)vi, (int32_t)ti, (int32_t)ni});
            }
            int32_t count = (int32_t)((int64_t)corners.size() - start);
            if (count >= 3) faces.emplace_back(start, count);
        }
        p = next_line(p, end);
    }

    size_t nv = vs.size() / 3, nn = vns.size() / 3, nt = vts.size() / 2;
    auto* mesh = new ObjMesh();
    std::unordered_map<CornerKey, int32_t, CornerHash> dedup;
    dedup.reserve(corners.size());

    auto emit = [&](const CornerKey& c) -> int32_t {
        auto it = dedup.find(c);
        if (it != dedup.end()) return it->second;
        int32_t k = (int32_t)(mesh->positions.size() / 3);
        dedup.emplace(c, k);
        int32_t vi = fix_index(c.v, nv);
        if (vi < 0 || (size_t)vi >= nv) vi = 0;
        mesh->positions.push_back(vs[3 * vi + 0]);
        mesh->positions.push_back(vs[3 * vi + 1]);
        mesh->positions.push_back(vs[3 * vi + 2]);
        if (nn && c.n != 0) {
            int32_t ni = fix_index(c.n, nn);
            if (ni >= 0 && (size_t)ni < nn) {
                mesh->normals.push_back(vns[3 * ni + 0]);
                mesh->normals.push_back(vns[3 * ni + 1]);
                mesh->normals.push_back(vns[3 * ni + 2]);
                mesh->n_norm_emitted++;
            }
        }
        if (nt && c.t != 0) {
            int32_t ti = fix_index(c.t, nt);
            if (ti >= 0 && (size_t)ti < nt) {
                mesh->uvs.push_back(vts[2 * ti + 0]);
                mesh->uvs.push_back(vts[2 * ti + 1]);
                mesh->n_uv_emitted++;
            }
        }
        return k;
    };

    std::vector<int32_t> fidx;
    for (auto& fc : faces) {
        fidx.clear();
        for (int32_t j = 0; j < fc.second; ++j)
            fidx.push_back(emit(corners[(size_t)fc.first + j]));
        for (int32_t j = 1; j + 1 < fc.second; ++j) {
            mesh->indices.push_back(fidx[0]);
            mesh->indices.push_back(fidx[j]);
            mesh->indices.push_back(fidx[j + 1]);
        }
    }

    size_t verts = mesh->positions.size() / 3;
    *out_handle = mesh;
    *n_verts = (int64_t)verts;
    *n_tris = (int64_t)(mesh->indices.size() / 3);
    // match the Python loader: attributes count only if EVERY emitted
    // vertex got one
    *has_normals = (mesh->n_norm_emitted == verts && verts > 0) ? 1 : 0;
    *has_uvs = (mesh->n_uv_emitted == verts && verts > 0) ? 1 : 0;
    return 0;
}

const float* mitpu_obj_positions(void* handle) {
    return ((ObjMesh*)handle)->positions.data();
}
const float* mitpu_obj_normals(void* handle) {
    return ((ObjMesh*)handle)->normals.data();
}
const float* mitpu_obj_uvs(void* handle) {
    return ((ObjMesh*)handle)->uvs.data();
}
const int32_t* mitpu_obj_indices(void* handle) {
    return ((ObjMesh*)handle)->indices.data();
}
void mitpu_obj_free(void* handle) { delete (ObjMesh*)handle; }

}  // extern "C"
