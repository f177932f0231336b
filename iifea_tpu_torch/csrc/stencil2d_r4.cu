// The f32 instances of the 2D stencil kernels (csrc/stencil2d.cuh) at
// r = 4, the cubic B-spline background's 81-tap stencil, in a source of
// their own so that nvcc compiles them beside the others; the public
// entries of csrc/stencil2d.cu call these for f32 operands at r = 4.

#include "stencil2d.cuh"

STENCIL2D_ENTRIES(r4_f32, float, 4, 4)
