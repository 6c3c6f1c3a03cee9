// The tiled and the separable resample kernels of resized_crop.cu on
// float32 NHWC images (loaded and stored as they are), in a library of
// their own that builds beside resized_crop.cu's.  resized_crop.cu's header comment describes them; the
// general kernel's float32 instance there is their bit oracle.

#include "resized_crop.cuh"

PST_TILED_ENTRY(pst_resized_crop_tiled_f32, ElemF32)
PST_SEPARABLE_ENTRY(pst_resample_separable_f32, ElemF32)
