// C interface of the container-and-foam pass (container.cu).
//
// Every pointer is device memory laid out as the port's tensors are.  The
// [n][3] float32 columns may be strided views of a wider buffer (the
// emitted-row transport's are) as long as the three words of a row lie
// together: each comes with its row stride in floats (3 when contiguous),
// and each [n] float32 column with its stride (1 when contiguous).  ghost,
// valid and face are [n] int32, contiguous.  The outputs are new contiguous
// [n][3] and [n] float32 arrays; an output pointer that is null is not
// written (the caller passes that column through as it is).
//
// The params are the FluidParams tensors themselves, read through their
// pointers when the kernel runs, so a launch captured into a CUDA graph
// reads the values of its replay, not of its capture.
//
// The launch goes on `stream` (a cudaStream_t) and the function neither
// synchronises nor allocates.  It returns cudaGetLastError() after its
// launch: 0 means launched.
#pragma once

#ifdef __cplusplus
extern "C" {
#endif

// The FluidParams fields the pass reads.
typedef struct {
  const float* center;        // [3] box_center
  const float* half;          // [3] box_half
  const float* euler_deg;     // [3] box_euler_deg, XYZ degrees
  const float* aux;           // [3] shape_aux
  const float* restitution;   // [] wall_restitution
  const float* friction;      // [] wall_friction
  const float* rest_density;  // [] rest_density
  const float* foam_gen;      // [] foam_gen
  const float* foam_vel_ref;  // [] foam_vel_ref
  const int* face_active;     // [6] ghost_face_active, -X +X -Y +Y -Z +Z
  const float* trefoil;       // [48][3] the knot's unit-scale samples
} SphContainerParams;

// The rows of one launch.  The state's columns: pos and vel are the
// container's input when the pass does not reassemble; acc, vel, density
// and pressure are what an inactive ghost keeps when it does.  The sweeps'
// outputs (npos, nvel, nacc, rho, pres) are read only when it reassembles.
typedef struct {
  const float* pos;
  const float* vel;
  const float* acc;
  const float* density;
  const float* pressure;
  const float* foam;
  const int* ghost;
  const int* valid;
  const int* face;
  const float* npos;
  const float* nvel;
  const float* nacc;
  const float* rho;
  const float* pres;
  int pos_stride, vel_stride, acc_stride;
  int density_stride, pressure_stride, foam_stride;
  int npos_stride, nvel_stride, nacc_stride, rho_stride, pres_stride;
  float* out_pos;
  float* out_vel;
  float* out_acc;
  float* out_density;
  float* out_pressure;
  float* out_foam;
} SphContainerRows;

// One pass over n rows: with reassemble, foam on the fluid rows and (with
// has_ghosts) the ghost rows' values; with contain, the container of
// shape_type (0..9) on the rows that result.  At least one of the two.
int sph_container(const SphContainerRows* rows,
                  const SphContainerParams* params, int n, int shape_type,
                  int reassemble, int contain, int has_ghosts, void* stream);

#ifdef __cplusplus
}
#endif
