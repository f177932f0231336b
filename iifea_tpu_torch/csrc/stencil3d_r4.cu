// The f32 instances of the 3D stencil kernels (csrc/stencil3d.cuh) at
// r = 4, the cubic B-spline background's 729-tap stencil, in a source of
// their own so that nvcc compiles them beside the others; the public
// entries of csrc/stencil3d.cu call these for f32 operands at r = 4.

#include "stencil3d.cuh"

STENCIL3D_ENTRIES(r4_f32, float, 4, 4)
