// Z-buffered triangle rasterizer with per-vertex colors: a copy of
// sph_tpu/native/tri_raster.cpp, built with g++ by
// sph_tpu_torch/native/build.py, the host core of the headless mesh passes
// (the terrain mesh, terrainVert/Frag.glsl + Scene0p.cpp:2942-3123, and the
// instanced OBJ mesh path, Mesh.cpp:20-54 + defaultVert.glsl:30-35).
// ``raster.rasterize_plain`` (sph_tpu_torch/viz/raster.py) is its plain
// version, with the same float32 operations in the same order.
//
// Screen convention matches viz/splat.py: x right, y down, `depth` is
// positive view-space distance (smaller wins the z-test).
#include <algorithm>
#include <cmath>
#include <cstdint>

extern "C" {

// rgb:  [H*W*3] float32 framebuffer 0..255 (in/out)
// zbuf: [H*W] float32 depth buffer (in/out; init to +inf by caller)
// vx/vy: [V] screen-pixel coords; vz: [V] positive view depth
// vr/vg/vb: [V] vertex colors 0..1 (scaled by 255 on write)
// tri:  [T*3] int32 vertex indices
void rasterize_tris(float* rgb, float* zbuf, int h, int w,
                    const float* vx, const float* vy, const float* vz,
                    const float* vr, const float* vg, const float* vb,
                    const int32_t* tri, int64_t t_count) {
    for (int64_t t = 0; t < t_count; ++t) {
        const int i0 = tri[3 * t], i1 = tri[3 * t + 1],
                  i2 = tri[3 * t + 2];
        const float x0 = vx[i0], y0 = vy[i0];
        const float x1 = vx[i1], y1 = vy[i1];
        const float x2 = vx[i2], y2 = vy[i2];
        // vertices behind the camera are pre-culled by the caller
        // (depth <= 0 sentinel)
        if (vz[i0] <= 0.f || vz[i1] <= 0.f || vz[i2] <= 0.f) continue;

        float area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0);
        if (std::fabs(area) < 1e-12f) continue;
        const float inv_area = 1.0f / area;

        int minx = (int)std::floor(std::min({x0, x1, x2}));
        int maxx = (int)std::ceil(std::max({x0, x1, x2}));
        int miny = (int)std::floor(std::min({y0, y1, y2}));
        int maxy = (int)std::ceil(std::max({y0, y1, y2}));
        minx = std::max(minx, 0);
        miny = std::max(miny, 0);
        maxx = std::min(maxx, w - 1);
        maxy = std::min(maxy, h - 1);
        if (minx > maxx || miny > maxy) continue;

        // perspective-correct interpolation: attributes pre-divided
        // by z, interpolate 1/z linearly in screen space
        const float iz0 = 1.0f / vz[i0], iz1 = 1.0f / vz[i1],
                    iz2 = 1.0f / vz[i2];
        const float r0 = vr[i0] * iz0, r1 = vr[i1] * iz1,
                    r2 = vr[i2] * iz2;
        const float g0 = vg[i0] * iz0, g1 = vg[i1] * iz1,
                    g2 = vg[i2] * iz2;
        const float b0 = vb[i0] * iz0, b1 = vb[i1] * iz1,
                    b2 = vb[i2] * iz2;

        for (int py = miny; py <= maxy; ++py) {
            const float fy = (float)py + 0.5f;
            for (int px = minx; px <= maxx; ++px) {
                const float fx = (float)px + 0.5f;
                float w0 = ((x1 - fx) * (y2 - fy)
                            - (x2 - fx) * (y1 - fy)) * inv_area;
                float w1 = ((x2 - fx) * (y0 - fy)
                            - (x0 - fx) * (y2 - fy)) * inv_area;
                float w2 = 1.0f - w0 - w1;
                if (w0 < 0.f || w1 < 0.f || w2 < 0.f) continue;
                const float iz = w0 * iz0 + w1 * iz1 + w2 * iz2;
                const float z = 1.0f / iz;
                const int64_t pi = (int64_t)py * w + px;
                if (z >= zbuf[pi]) continue;
                zbuf[pi] = z;
                rgb[3 * pi + 0] =
                    255.0f * (w0 * r0 + w1 * r1 + w2 * r2) * z;
                rgb[3 * pi + 1] =
                    255.0f * (w0 * g0 + w1 * g1 + w2 * g2) * z;
                rgb[3 * pi + 2] =
                    255.0f * (w0 * b0 + w1 * b1 + w2 * b2) * z;
            }
        }
    }
}

}  // extern "C"
