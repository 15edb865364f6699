// Painter-splat rasterizers: the host cores of the headless particle
// renderer (sph_tpu_torch/viz/splat.py) and of the SSFR water's first pass
// (sph_tpu_torch/viz/ssfr.py), built with g++ by
// sph_tpu_torch/native/build.py.  A copy of sph_tpu/native/splat_raster.cpp,
// so that frames of the two packages compose alike pixel for pixel.
//
// ``splat_raster``: particles arrive painter-sorted (far -> near), each
// overwrites its disc footprint, with optional fake-sphere shading
// (particleImpostor.frag:252-258); the numpy loop
// ``splat.render_frame_plain`` is its plain version.
#include <cmath>
#include <cstdint>

extern "C" {

void splat_raster(int n,
                  const float* cx, const float* cy,
                  const float* rad_px,
                  const float* colors,      // [n,3]
                  int width, int height,
                  float* img,               // [h,w,3] prefilled background
                  int lit,
                  const float* light3,      // view-space sun dir (lit mode)
                  const float* sun_color3,
                  int max_footprint,
                  const float* depth_in,    // [n] view depth or nullptr
                  float* zbuf) {            // [h,w] prefilled 0 or nullptr
    const float lx = light3[0], ly = light3[1], lz = light3[2];
    const float sr = sun_color3[0], sg = sun_color3[1], sb = sun_color3[2];
    for (int i = 0; i < n; ++i) {
        const float r = rad_px[i];
        const float cr = colors[3 * i + 0];
        const float cg = colors[3 * i + 1];
        const float cb = colors[3 * i + 2];
        const int fp = max_footprint;
        for (int dy = -fp; dy <= fp; ++dy) {
            for (int dx = -fp; dx <= fp; ++dx) {
                const float d = std::sqrt(float(dx * dx + dy * dy));
                if (d > r) continue;
                const int x = int(cx[i] + float(dx));
                const int y = int(cy[i] + float(dy));
                if (x < 0 || x >= width || y < 0 || y >= height) continue;
                float pr = cr, pg = cg, pb = cb;
                if (lit) {
                    const float rc = r < 0.5f ? 0.5f : r;
                    float nr = d / rc;
                    if (nr > 0.97f) nr = 0.97f;
                    const float nz = std::sqrt(1.0f - nr * nr);
                    const float dd = d < 1e-6f ? 1e-6f : d;
                    const float nx = (float(dx) / dd) * nr;
                    const float ny = (float(-dy) / dd) * nr;
                    float diff = nx * lx + ny * ly + nz * lz;
                    if (diff < 0.0f) diff = 0.0f;
                    const float shade = 0.35f + 0.65f * diff;
                    const float spec = std::pow(diff, 24.0f) * 0.4f;
                    pr = pr * shade + sr * spec;
                    pg = pg * shade + sg * spec;
                    pb = pb * shade + sb * spec;
                    if (pr > 1.0f) pr = 1.0f;
                    if (pg > 1.0f) pg = 1.0f;
                    if (pb > 1.0f) pb = 1.0f;
                    if (pr < 0.0f) pr = 0.0f;
                    if (pg < 0.0f) pg = 0.0f;
                    if (pb < 0.0f) pb = 0.0f;
                }
                float* px = img + 3 * (size_t(y) * width + x);
                px[0] = pr;
                px[1] = pg;
                px[2] = pb;
                if (zbuf && depth_in) zbuf[size_t(y) * width + x] = depth_in[i];
            }
        }
    }
}

// SSFR pass-1 splatting (sph_tpu_torch/viz/ssfr.py splat_depth_thickness):
// particles arrive painter-sorted by view z ascending (most negative =
// farthest first), each ASSIGNS its sphere-surface depth (near overwrites
// far) and adds Gaussian thickness + foam blobs (fluidDepth.frag /
// fluidThickness.frag).  ``ssfr.splat_depth_thickness_plain`` is its plain
// version, the same float32 operations in the same order.
void ssfr_splat(int n,
                const float* cx, const float* cy,
                const float* vz,          // view z (negative in front)
                const float* rad_px,      // clamped [0.6, 6.0]
                const float* foam,
                float particle_radius,
                int width, int height,
                float* depth,             // [h,w] prefilled 0
                float* thick,             // [h,w] prefilled 0
                float* foam_img) {        // [h,w] prefilled 0
    const int fp = 3;                     // fixed footprint, ssfr.py r=3
    for (int i = 0; i < n; ++i) {
        const float r = rad_px[i];
        const float r2 = r * r;
        const float z = vz[i];
        const float fo = foam[i];
        for (int dy = -fp; dy <= fp; ++dy) {
            for (int dx = -fp; dx <= fp; ++dx) {
                const float d2 = float(dx * dx + dy * dy);
                if (d2 > r2) continue;
                const int x = int(cx[i] + float(dx));
                const int y = int(cy[i] + float(dy));
                if (x < 0 || x >= width || y < 0 || y >= height) continue;
                const size_t p = size_t(y) * width + x;
                const float denom = r2 > 0.36f ? r2 : 0.36f;
                float s = 1.0f - d2 / denom;
                if (s < 0.0f) s = 0.0f;
                depth[p] = z + particle_radius * std::sqrt(s);
                const float gden = 0.5f * r2 > 0.18f ? 0.5f * r2 : 0.18f;
                const float g = std::exp(-d2 / gden);
                thick[p] += g;
                foam_img[p] += fo * g;
            }
        }
    }
}

}  // extern "C"
