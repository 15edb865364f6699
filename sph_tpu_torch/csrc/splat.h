// C interface of the frame export's splat composition on the card
// (splat.cu).
//
// Every array pointer is device memory laid out as the port's tensors are:
// pos [n][3] float32, valid and ghost [n] int32, mask [n] bool (one byte a
// row) or null, all contiguous.  The frame has P = width * height pixels,
// row-major from the top left.  The camera block is read on the host and
// passed to the kernels by value.
//
// The launches go on `stream` (a cudaStream_t); neither function
// synchronises or allocates, and each returns cudaGetLastError() after its
// launches: 0 means launched.
#pragma once

#ifdef __cplusplus
extern "C" {
#endif

// What the composition reads of the camera, the frame and the light, each
// as the host path (viz/splat.py) rounds it to float32.
typedef struct {
  float view[3][4];       // the view matrix's rows 0-2
  float proj[2][4];       // the projection's rows 0-1
  float size;             // 2 r P[1][1], the point size's numerator
  float light[3];         // the sun's direction in view space
  float sun[3];           // the sun's colour
  float background[3];    // the background colour (no background image)
  int width, height;
  int footprint;          // the largest disc radius in pixels
  int lit;                // 1: the fake-sphere shading
  int row_shift;          // bits of a key below the row: the footprint's
} SphSplatCamera;

// The state's columns that the owners' colours read, [n] rows each, and
// where their gathered copies go: `owners` is [12][P] float32, planes of
// P values, in order pos [P][3], view-space pos [P][3], vel [P][3],
// pressure [P], density [P] and color_group [P] (int32 bits).
typedef struct {
  const float* vel;           // [n][3]
  const float* pressure;      // [n]
  const float* density;       // [n]
  const int* color_group;     // [n]
  float* owners;              // [12][P]
} SphSplatOwners;

// keys [P] uint64: zeroed, then each pixel takes the largest key of the
// drawn rows' disc offsets that cover it (the painter's last writer);
// then each pixel's owner row (row 0 for the background) is gathered into
// `cols->owners`, its view-space position computed as the keys' was.
int sph_splat_keys(const float* pos, const int* valid, const int* ghost,
                   const unsigned char* mask, int n,
                   const SphSplatCamera* cam, const SphSplatOwners* cols,
                   unsigned long long* keys, void* stream);

// image [P][3] uint8: each pixel shaded from its owner (colors [P][3]
// float32, the owner's colour; owners as sph_splat_keys wrote them) or the
// background (background [P][3] uint8 if not null, else the camera's
// colour), clamped and scaled to 8 bits; depth [P] float32 if not null:
// the owner's view depth, 0 for the background.
int sph_splat_shade(const unsigned long long* keys, const float* owners,
                    const float* colors, const unsigned char* background,
                    const SphSplatCamera* cam, unsigned char* image,
                    float* depth, void* stream);

#ifdef __cplusplus
}
#endif
