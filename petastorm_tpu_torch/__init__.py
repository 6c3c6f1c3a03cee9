"""petastorm_tpu_torch: the PyTorch/CUDA port of petastorm_tpu.

Parquet datasets of images and tensors are read and decoded on the host
(``make_reader``), assembled into exact-size batches and moved to a CUDA
device (``cuda.CudaDataLoader``), normalized there by a hand-written Hopper
kernel (``ops.normalize_images``) and fed to a torch model
(``models.ResNet50``).  The package imports nothing of ``petastorm_tpu``: it
keeps its own copies of the host-side modules it needs, under the same
module names.
"""

from petastorm_tpu_torch.codecs import (CompressedImageCodec, CompressedNdarrayCodec,
                                        NdarrayCodec, ScalarCodec, ScalarListCodec)
from petastorm_tpu_torch.converter import make_converter
from petastorm_tpu_torch.errors import ErrorPolicy, NoDataAvailableError, PetastormTpuError
from petastorm_tpu_torch.etl.writer import materialize_dataset, write_dataset
from petastorm_tpu_torch.reader import Reader, make_batch_reader, make_reader
from petastorm_tpu_torch.schema import Field, Schema
from petastorm_tpu_torch.transform import TransformSpec

__version__ = "0.1.0"

__all__ = ["CompressedImageCodec", "CompressedNdarrayCodec", "ErrorPolicy", "Field",
           "NdarrayCodec", "NoDataAvailableError", "PetastormTpuError", "Reader",
           "ScalarCodec", "ScalarListCodec", "Schema", "TransformSpec", "make_batch_reader",
           "make_converter", "make_reader", "materialize_dataset", "write_dataset"]
