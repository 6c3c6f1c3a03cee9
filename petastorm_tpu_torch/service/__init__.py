"""Disaggregated ingest service: dispatcher + elastic remote-worker fleet.

The port's copy of ``petastorm_tpu/service/``.  A standalone **dispatcher**
owns work-item assignment over each client's plan stream, an elastic fleet
of **remote workers** runs the same decode path as the in-process pools
(``worker.RowGroupDecoderWorker``, shipped to the workers as the pickled
worker factory), and trainer processes consume through a **client
executor** (:class:`ServiceExecutor`) that keeps the port's executor
contract, so ``make_reader(service_address=...)`` swaps the worker plane
with nothing changed downstream: plan-order delivery, the cursor, the
stream digest, ``on_error`` policies and ``CudaDataLoader`` all behave as
with a local pool.  Co-located workers using ``cache_type='shared'`` decode
each rowgroup once across every client of the dataset, and a worker with an
shm arena hands its batches to a client on its host as ``"shm"``
descriptors.

The dispatcher, the workers and the autoscale supervisor import no
``torch``: the trainer is the only process that does.  Every frame is the
JAX package's, byte for byte (``wire.py``, ``journal.py``).

Topology::

    trainer A --make_reader(service_address=...)--+
                                                  +--> dispatcher <--+-- worker 1
    trainer B --make_reader(service_address=...)--+                  +-- worker 2
                                                                     +-- worker N

Entry points: ``python -m petastorm_tpu_torch.service.cli
dispatcher|worker|autoscale|stats`` (the ``petastorm-tpu-torch-service``
console script), :class:`Dispatcher`, :class:`ServiceWorker`,
:class:`ServiceExecutor` and :class:`AutoscaleSupervisor`.
"""

from petastorm_tpu_torch.service.autoscale import AutoscalePolicy, AutoscaleSupervisor
from petastorm_tpu_torch.service.client import ServiceConnectionError, ServiceExecutor
from petastorm_tpu_torch.service.dispatcher import Dispatcher
from petastorm_tpu_torch.service.worker import ServiceWorker

__all__ = ["Dispatcher", "ServiceWorker", "ServiceExecutor",
           "ServiceConnectionError", "AutoscalePolicy",
           "AutoscaleSupervisor"]
