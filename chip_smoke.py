"""Drives the PyTorch/CUDA port on one NVIDIA GPU and checks it.

Run from the root of a checkout with ``python3 chip_smoke.py`` on a machine
with a CUDA GPU and ``nvcc``.  Phases, each printing one line:

1. env: torch/CUDA versions, and the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives them;
2. build: every ``petastorm_tpu_torch/csrc/*.cu`` compiled from the checkout,
   one ``nvcc`` per source, the entropy half of the hybrid JPEG decode
   (``petastorm_tpu_torch/native/jpeg_coef.cpp``, g++) and the batched host
   decode (``native/image_decode.cpp``, g++, linking libjpeg and libpng), all
   at once, with the libjpeg and libpng they link; the
   registers, stack and spills ptxas reported for each JPEG decode kernel
   and their SASS instruction counts (``cuobjdump``);
3. kernels: each kernel against its plain PyTorch version on the card at the
   main path's shapes (and ragged and unaligned ones), with its time, the
   plain version's time, the least time the card could take and, where one
   PyTorch call computes the same function, that call's time; each
   resized-crop kernel (tiled without antialias, antialiased tiled with it)
   equal on every byte to the general kernel wherever both apply, and
   timed in turns against it; their float32, float16 and bfloat16 instances
   (the training crop, the 256 -> 224 evaluation resize, cubic, Lanczos 3
   and Lanczos 5 at phase 33 (b)'s shape, and ragged, unaligned, one- and
   five-channel shapes) equal bit for bit to the general kernel's float32
   instance (cast back for the 16-bit types) and held to the plain version,
   timed in turns against that instance at the element size's bound, beside
   ``F.grid_sample`` and ``F.interpolate(antialias=True)`` in float32;
   int16 images through their float32 instance, and normalize at 65 and
   300 channels; the JPEG decode
   (B2) on coefficient planes of cv2-encoded images at the training batch
   (256 x 224 x 224, 4:2:0), 4:4:4, 4:2:2, grayscale, 37 x 53, progressive
   and float32 output: the tiled kernel, which the path takes, equal on
   every byte (uint8) and bit (float32) to the general kernel of the first
   port and both against the plain version, against cv2 at the main shape,
   and timed in turns against the general kernel, hot and with the L2
   flushed before each launch; block attention (B4, forward and backward)
   at the long-context trainer's ring block ``(2, 32, 2048, 128)`` float32:
   a diagonal causal block, an off-diagonal block and a block whose first
   1024 rows see none of its keys, the tensor-core kernels and the SIMT
   kernels they replaced each against the plain version, timed (CUDA
   events) in turns against the SIMT kernels, beside the bounds at 67
   TFLOP/s float32 and 165 TFLOP/s 3xTF32, the plain version and
   ``F.scaled_dot_product_attention`` in float32 on the same block, with
   ptxas's facts and each kernel's SASS HMMA count; the
   backward's row-delta kernel (``rowsum(dout * out)``, an entry of its own)
   against its plain version and ``torch.linalg.vecdot``;
4. main path (inference): an ImageNet-shaped JPEG dataset (4096 rows of
   224x224x3, 16 rowgroups) through ``make_reader`` ->
   ``CudaDataLoader(batch_size=256)`` -> ``normalize_images`` -> ``ResNet50``
   (bf16, seeded random weights) for one epoch: samples/s, the consumer's
   input-wait share, peak device memory, the delivered labels against the
   written ones, finite logits, the kernels' launch counts, and the first
   images' logits against a float32 run of the plain path; the reader's
   native decode counters show every image of the epoch decoded by the
   batched native call (``batch_images``), none per cell;
5. train path: the same dataset (labels mod 1000) through ``make_reader`` ->
   ``CudaDataLoader(batch_size=256)`` -> the trainer's step (resized crop +
   flip, normalize, ResNet-50 with float32 leaves computing in bf16, one-hot
   cross-entropy, SGD with momentum) for one epoch of 16 steps: samples/s,
   the input-wait share, peak device memory, the model FLOPs per sample and
   the achieved FLOP rate against a measured bf16 matmul peak, a finite loss
   at every step, the kernels' launch counts, and one bf16 step against one
   float32 step of the plain path from the same weights, boxes and flips.
   The reader decodes on the host (``decode_placement={'image': 'host'}``),
   every image through the batched native call;
6. train path, device decode: phase 5 over the same dataset with
   ``decode_placement={'image': 'device'}`` (entropy decode in the workers,
   B2 on the card): samples/s, the input-wait share, one launch of B2's
   tiled kernel a step and none of the general one,
   the labels in phase 5's order, and the first batch's images against
   phase 5's (the host's native libjpeg decode, which phase 7 holds to cv2
   byte for byte) within the reference's bound;
7. reader decode rate: the dataset read for 4 epochs (64 rowgroups, about 4x
   the reader's in-flight window) with no model: the native host decode at
   ``decode_threads='auto'``, the same with ``decode_roi={'image':
   ('random', 160, 160)}``, and entropy decode only with the same fan-out,
   with the same workers, beside the machine's core count; one thread of the
   plain per-cell cv2 decode against one thread of ``decode_column_native``
   over the same 256-cell column; the native decode equal to the per-cell
   cv2 decode on every byte of the dataset, and the reader's ROI crops equal
   to slices of the full decode at the offsets a CPU run of the worker's
   ``_roi_for`` gives;
8. train path, device decode, shuffled: phase 6 with the loader's shuffle
   buffer (``shuffling_queue_capacity=2048``, the default floor of 1024,
   ``buffer_seed=0``) and its two producer threads: 16 steps, the epoch's
   labels as a multiset equal to phase 6's, in another order, and in the
   order the port's ``shuffle.iter_batched`` gives on the CPU over phase 6's
   labels (its draws depend only on the buffer's sizes); B2's tiled kernel,
   B3 and B1 once a step; samples/s beside phase 6's, the input-wait share,
   peak device memory, and the seconds a batch the assembly (shuffle, pad)
   and transfer (pinned staging, copies, B2) threads worked;
9. the torch adapter: ``petastorm_tpu_torch.pytorch.BatchedDataLoader`` over
   the dataset (host decode, ``shuffling_queue_capacity=2048``, ``seed=0``,
   ``transform_fn`` moving each tensor to the card) into ``normalize_images``
   and ResNet-50 inference for one epoch: 16 batches, the labels of a CPU run
   of the same adapter, B1 once a batch, every image decoded natively,
   samples/s beside phase 4's;
10. inference with the window drained: phase 4's path (host decode) for 4
   epochs of the dataset, 64 batches, about 4x the reader's in-flight
   window: samples/s over all timed batches and over the batches after the
   window drained, the input-wait share of each, B1 once a batch, every
   label 4 times and every image decoded natively;
11. stacked training with device decode: phase 6's path with the loader's
   ``stack_batches=4`` and the trainer's ``ScanStep`` (4 whole training
   steps captured once in a CUDA graph, replayed once a unit) over the
   dataset with ``num_epochs=None``: one warm-up unit and the capture, then
   3 timed units; samples/s beside phase 6's, the input-wait share, peak
   device memory, one B2 launch over 1024 images a unit, B1 and B3 4 times
   a replay (the launch counters count the capture; ``torch.profiler``
   counts the kernels of three replays by name, held exactly in the fullest
   record), and one unit replayed from the graph against the same unit run
   as 4 eager steps from the same weights, momentum and draws: the draws
   equal, the losses and leaves within twice the spread of two eager runs;
12. drain, checkpoint and resume: the host-decode training path
   (``drop_last=False``, ``num_epochs=1``, a small reader window) trains 6
   steps, drains the loader and trains on what it drained, saves model,
   optimizer, generator and loader cursor with ``checkpoint.save_checkpoint``,
   then a fresh model, optimizer, reader and loader restore it and train to
   the epoch's end: the labels of the two halves in phase 5's order, the
   resumed reader's digest equal to phase 5's reader's, the restored leaves
   and momentum equal to the saved ones bit for bit, and the first resumed
   step's loss within phase 11's bound of phase 5's same step; the times of
   the save and the restore;
13. shuffled inference: phase 4's path for one epoch three ways in one call:
   unshuffled, through the loader's host shuffle buffer (2048 rows,
   ``buffer_seed=0``) and through its device shuffle buffer
   (``device_shuffle_capacity=8``: 8 x 256 = 2048 rows, a 308 MB store on
   the card, ``device_shuffle_seed=0``), the last twice: each shuffled
   epoch's labels the unshuffled epoch's as a multiset in another order, the
   two device-buffer runs in one order, B1 once a batch; for each way
   samples/s, the input-wait share, ``assemble_s`` and ``transfer_s`` a
   batch and peak device memory, and the device buffer's exchange a push
   (CUDA events on the copy stream); a push alone at the main shapes under
   ``torch.cuda.set_sync_debug_mode('error')``: no host sync; a push alone
   on the idle card, timed against the least time of its bytes;
14. warm-cache training: phase 6's path (device decode: B2, B3, B1, the
   step) for 3 epochs with ``cache_type='memory'`` against the same with
   ``'null'``: 16 misses and 32 hits, the entropy decode in the first epoch
   only, the labels, every batch's image sum and the digest equal, the first
   batch's images after B2 bit for bit; samples/s an epoch, the cache's
   resident bytes; then the reader alone (entropy decode) for 4 epochs
   without a cache, with the memory tier and with the local-disk tier in a
   temporary directory: rows/s of the first epoch against the later ones;
15. filtered training, device decode: a rowgroup index built on a copy of
   the dataset (``etl.indexing.build_rowgroup_index``), read with a
   ``SingleIndexSelector`` keeping 12 of the 16 rowgroups,
   ``predicate=in_pseudorandom_split([0.75, 0.25], 0, 'label')`` and
   ``shuffle_row_drop_partitions=2`` for 2 epochs through phase 6's
   training path: samples/s beside phase 6's, the input-wait share, B2, B3
   and B1 once a step, the labels in the order of a CPU run of the same
   reader (serial pool), their multiset the host's filtered set twice, the
   digest the CPU run's, and the entropy decode counting only the rows that
   survive; then two shards in ``shard_mode='epoch'`` in turn, 2 epochs each,
   through the loader, B2, B1 and the forward: disjoint in each epoch, their
   union the filtered set, dealt differently in the two epochs, each
   shard's labels and digest its CPU run's;
16. transformed training, host decode, warm transform cache: a
   ``TransformSpec`` writing ``target`` = ``label`` mod 1000 (removing
   ``label``) with ``cache_type='memory'`` for 2 epochs through phase 5's
   training path on ``target``: samples/s an epoch, 16 transform misses and
   16 hits, one epoch's native decode only, ``transform_cache_info``'s
   verdict, B3 and B1 once a step, the targets in a CPU run's order; then
   one epoch of ``pytorch.BatchedDataLoader`` over the same reader into
   inference, its targets those of a CPU run of the adapter;
17. mixed-corpus training, device decode: phase 6's dataset and a second one
   of 2048 rows (the same schema, 8 rowgroups, another seed) mixed 0.75 /
   0.25 by ``WeightedSamplingReader`` through phase 6's training path for
   all 6144 rows (24 steps): samples/s beside phase 6's, the input-wait
   share, B2, B3 and B1 once a step, the labels batch by batch and the
   mixture digest (26 draws: 24 rowgroups and 2 exhaustions) equal to a CPU
   replay of the same readers and mixer;
18. NGram clip training, host decode: a frame dataset (4096 JPEG frames, 16
   rowgroups of 4 clips of 64 consecutive timestamps, a gap of 1000 between
   clips) read with a stacked 4-frame ``NGram`` and 2 row-drop partitions
   (the lookahead path), 64 windows a batch (``frame`` (64, 4, 224, 224, 3)
   uint8) viewed as 256 frames into phase 5's step, one epoch (3904
   windows, 61 steps): frames/s and windows/s, the input-wait share, the
   staged bytes a batch, B3 and B1 once a step, the window starts those
   ``NGram.window_starts`` gives on the CPU over the written timestamps (none
   lost or doubled), ``ts[:, j] == ts[:, 0] + j`` in every window, every
   decoded frame through the batched native call; the reader alone for 4
   epochs (windows/s, frames decoded/s) beside phase 7's rows/s; then the
   same windows unstacked through ``pytorch.BatchedDataLoader`` onto the
   card for 4 batches: ``{offset: {field: tensor}}``;
19. partitioned training, device decode: phase 4's rows written by the
   port's ``write_dataset`` with ``partition_by=['split']`` (4 splits of
   1024 rows, files of 256; a 14x14 ``mask`` stored with
   ``CompressedNdarrayCodec``), splits 0-2 in one call and split 3 appended;
   ``_common_metadata`` deleted and rebuilt by ``generate_metadata`` (the
   same rowgroup list and stream digest as before); one epoch of phase 6's
   path over splits 0-2 with the predicate pushed down to the partitions
   (12 steps, ``mask`` a host field): exactly 3072 rows, the labels and the
   digest of the reader alone on the CPU, 3072 images entropy-decoded,
   every mask as written, B2, B3 and B1 once a step; samples/s beside phase
   6's and the input-wait share; then split 3's files as a URL list through
   ``make_batch_reader``: 1024 rows of split 3;
20. poisoned training: phase 19's corpus copied, one JPEG cell of a split-1
   file cut inside its header (rewritten through ``materialize_dataset``)
   and a split-2 file overwritten with garbage; one epoch under
   ``on_error=ErrorPolicy(max_skipped_rowgroups=2)`` through phase 6's
   device-decode path and phase 5's host-decode path: 3584 rows each, both
   rowgroups quarantined as data errors at their paths, the labels and the
   digest of the reader alone on the CPU, the cursor at the epoch's end;
   samples/s beside phases 6 and 5 and the input-wait share; then a budget
   of 1 raises ``ErrorBudgetExceededError`` from the loader's ``next()``
   with its diagnostics, and both loader threads have ended;
21. mixed-geometry training: 2048 cv2-encoded JPEGs in 8 rowgroups of 256,
   their geometries drawn from a seed with ImageNet's common sizes (0.4
   375x500, 0.2 500x375, 0.2 333x500 4:2:0, 0.1 500x500 4:4:4, 0.1 375x500
   grayscale), a ``(None, None, 3)`` field with its geometry contract
   stamped, read with ``decode_placement={'image': 'device-mixed'}`` into
   ``CudaDataLoader(pad_shapes={'image': (500, 500, 3)})`` (the pinned
   arena, B2 once a geometry bucket, the fit) and phase 6's training step
   for 2 epochs (16 steps): samples/s beside phase 6's, the input-wait
   share, B2's launches equal to the batches' geometry buckets, the labels
   and digest of the reader alone on the CPU; on the first batch each
   bucket's B2 decode equal to the general kernel and within its bound of
   the plain version, every delivered row equal to it (cropped, grayscale
   repeated), against cv2 under the same rule as phase 6, the pad region
   zero; the loader's pack, copy and decode-and-fit of that batch timed,
   and its buckets' B2 launches from a CUDA graph beside their bound;
22. the converter feed: phase 4's rows as a pyarrow table through
   ``make_converter`` (rowgroups of 256) and ``make_cuda_loader`` into
   phase 5's host-decode training path for one epoch (16 steps), the JPEG
   bytes (binary in the converter's inferred schema) decoded by a
   ``TransformSpec`` in one native call a rowgroup: samples/s beside phase
   5's, the write's seconds, a second conversion of the table returning the
   same handle with no write, the labels and digest of the reader alone on
   the CPU, the first batch equal to cv2's decode; then ``delete()``;
23. the token feed: two token corpora (24,576 and 6,144 documents, int32
   ``token_field`` in rowgroups of 512, lognormal lengths of median 512
   tokens cut at 16,384, ids in GPT-2's [0, 50257); about 20 M tokens)
   written in bulk, mixed 0.8 / 0.2 with ``seed=7`` and packed into
   ``(8, 2048)`` blocks (``long_docs='split'``) by
   ``sequence.make_packed_sequence_loader(..., device='cuda')`` with the
   reader's default workers, run to exhaustion: tokens/s and rows/s
   delivered to the card, the packer's fill rate, documents and splits, the
   input-wait share, the write's seconds; every column on the card with its
   dtype, and the ``packed_stream_digest`` of the delivered valid rows (copied
   back) equal to a CPU run of ``iter_packed_blocks`` over the same mixture,
   its packer's counts equal too; the CPU packing's and the mixed reader's
   own tokens/s (documents decoded, nothing packed);
24. the MNIST trainer: B1 at ``(32, 28, 28, 1)`` (one channel, 25 KB) against
   its plain version within phase 3's bound, timed beside its bound; then
   ``examples.mnist.train_mnist_cuda.train`` over 60,000 synthetic rows
   (MNIST's training size), batch 32, one epoch: samples/s, the input-wait
   share, B1 once a step and its plain version never, the epoch's accuracy
   above 0.9; the step alone on a resident batch (ms a step, and its device
   time by op from ``torch.profiler``); then the hello-world example (rows, batches, and a
   ``CudaDataLoader`` feed on the card) and the preemption example on the
   card (drain, ``checkpoint.save_checkpoint``, restore into fresh objects):
   every row trained exactly once across the two incarnations;
25. the port's multi-process selfcheck on the card, its ranks on ``cuda:0``
   over gloo (``parallel.selfcheck``): ``run_selfcheck`` (sharded reading,
   global batches rebuilt from both ranks' blocks, a masked global mean a
   step, the unequal drain through the default collective, an elastic
   resume under 3 processes), ``run_distributed_write_check``,
   ``run_context_parallel_check`` (ring and Ulysses over sequence-sharded
   delivery against float64 full attention), ``run_shuffled_check`` (4
   ranks: seeded shuffled stacked delivery and drain, one global order on
   every rank, the exact multiset, the seeded interleave, |rho| <= 0.5),
   ``run_mixed_check`` (``'device-mixed'`` decode, B2 in each rank, the
   gathered pixels equal on both ranks and within max 6 / mean 1 of a host
   decode) and ``run_mesh2d_check`` (4 ranks on a 2 x 2 ``("data",
   "model")`` mesh), with the transport printed; and the packed token
   loader over a 2-rank mesh to exhaustion (phase 23's second corpus,
   ``(8, 2048)`` global batches), each rank's rows' digest equal to the CPU
   packing of its shard; the last three checks and the packed loader run at
   once;
26. the long-context trainer (``examples/long_context/
   train_ring_attention_cuda``) at Llama-2-7B's attention widths (32 heads
   of 128, vocabulary 32,000, rows of 4,096 tokens), two ranks on the
   ``seq`` dimension sharing ``cuda:0`` over gloo (host-staged transfers),
   ring then Ulysses, global batch 2, 1 warm-up and 3 timed steps each: the
   first step's loss, attention output and gradients against the same step
   with B4's plain versions in the same processes (the loss sits at
   ln(32000) at this init whatever the attention gives, so the attention
   output, within 1e-5 of its max, and the gradients, within 1e-4, are the
   check), tokens/s, step ms, the input-idle share,
   peak memory a rank, B4's launches (no plain attention call on the card);
   every child process has a timeout, and a failed or late rank fails the
   run;
27. the data-parallel flagship trainer (``train_resnet_cuda`` under two
   ranks sharing ``cuda:0`` over gloo): phase 6's dataset with device
   decode, global batch 256 (128 a rank), ResNet-50 at its published
   widths, 2 warm-up and 4 timed steps: the ranks' leaves equal bit for bit
   (a digest a rank), B1, B3 and B2 in every rank, samples/s/GPU, the
   all-reduce's ms a step and the transport; the first step recomputed here
   from the seed-0 weights and the gathered global batch and draws, over
   the ranks' two blocks (within 1e-6 of max|leaf|) and in one pass (the
   update within 0.03 relative);
28. remote read: phase 6's training through ``test_util.latency_fs`` (20 ms
   a request, the first 2 opens and 2 reads failing) with
   ``io_retries='auto'``: the labels and the first batch's pixels equal
   phase 6's, 3 retries counted (the ``_common_metadata`` probe takes one
   failure without a retry, as in the JAX package), one ranged read a
   rowgroup, samples/s beside phase 6's; then a store failing every request
   raises ``CircuitOpenError`` within 10 s;
29. the process pool on the main path: phase 6's and then phase 5's
   training epoch with ``reader_pool_type='process'`` (spawned workers, the
   default 7 of them, results through a shared-memory arena the reader
   sizes to the window of 17 rowgroups and 4 more: 1.62 GB for the
   coefficient planes, counted at twice the pixels, 0.81 GB for the pixels,
   so no batch waits for room): the labels and every batch's image
   sum equal phases 6's and 5's, B2, B3 and B1 once a batch or step, every
   batch through the arena and none pickled, the host route's images all
   decoded straight into arena slots, no child process left after
   ``stop()``; samples/s beside phases 5's and 6's, the input-idle share,
   the arena's high-water mark, the workers' spawn seconds and resident sets;
30. liveness under chaos (``test_util.chaos.ChaosSpec``) on phase 6's
   device route: the process pool with one ordinal hung past
   ``item_deadline_s=5`` (killed and respawned) and one worker killed with
   ``os._exit`` (its item requeued); the thread pool with the same hang
   (its slot abandoned); a slow ordinal (3 s) under ``hedge_after_s=1``
   (hedged, delivered once); each training its epoch with phase 29's
   labels and image sums, B2, B3 and B1 counted, and the wall time the hang
   cost held to the deadline plus one respawn; then every attempt hanging
   with no deadline and ``stall_abort_s=5``: ``PipelineStallError`` within
   10 s of the last batch, its diagnostics naming the stuck ordinal, and no
   loader thread or worker process left;
31. observability and self-tuning on the main path, phase 6's training step
   with B2, B3 and B1 counted in each part: (a) one epoch with a
   ``telemetry.Telemetry`` recorder, ``metrics_port``, ``flight_record_path``
   and the sampler, phase 6's labels and image sums, a localhost scrape in
   the epoch showing the stage and queue series, a dominant stage, a flight
   record written and read back, samples/s beside phase 6's; then
   TRACE_STEPS steps through a loader with ``trace_dir``, whose
   ``torch.profiler`` trace names B2's, B3's and B1's kernels; (b) one epoch
   with ``decode_placement={'image': 'auto'}`` and ``workers_count='auto'``
   (planner and autotune armed), ``set_decode_split('host')`` after step 8:
   B2 once on each device-form batch and never on a host-form one, each
   batch's image sum phase 5's (host form) or phase 6's (device form), the
   planner's and autotune's diagnostics, and a second reader planned from
   the written profile; (c) ``cache_type='shared'``: two epochs, then a
   spawned process attached to the same namespace, every later read an L1
   hit with phase 6's labels and sums, samples/s beside phase 14's warm
   cache, and no segment left after ``cleanup()``;
32. the ingest service on the main path: a dispatcher and 3 workers (2 items
   each, an shm arena each sized to the reader's window) started by
   ``python -m petastorm_tpu_torch.service.cli`` as processes of this host,
   then phase 6's training feed through ``make_reader(...,
   service_address=...)``: (a) one epoch, phase 6's labels and image sums,
   B2, B3 and B1 once a batch, every result an ``"shm"`` payload, samples/s,
   input-idle share and epoch seconds beside phases 6 and 29, the fleet's
   entropy decode of the epoch's images and the workers' shm payload cost;
   (b) the epoch again beside a second, host-only tenant on a thread, both
   on the workers' shared tier: each its exact rows, the fleet decoding each
   rowgroup once (the tier's misses, the fleet's decode counters), the
   slowdown; (c) an epoch with ``trace_items=True`` whose items each sleep
   SERVICE_SLOW_S, once clean and once with a worker SIGKILLed after step 4:
   phase 6's labels and sums, items requeued, a merged trace with client,
   dispatcher and worker tracks, the ``service.hop.*`` p50s and the seconds
   the kill cost; every fleet process reaped and no shm segment left;
33. the other resampling methods, legacy Petastorm datasets, the matrix and
   the converter: (a) the general resize kernel's Keys-cubic, Lanczos 3 and
   Lanczos 5 instances against their plain versions, antialias off and on:
   ``random_resized_crop`` over (256, 256, 256, 3) uint8 -> 224x224 with
   drawn boxes and flips, ``resize_images`` 256 -> 224 and 128 -> 224, one
   float32 crop each (uint8 within 1 LSB on at most 1 % of bytes, float32
   within 1e-5 of max|x|), and the nearest gather kernel equal to its plain
   version down and up, uint8 and float32; each case's median and first-call
   times, plain time and bound, and for nearest ``F.interpolate(
   mode='nearest-exact')`` on the same bytes; (b) phase 4's dataset copied
   into the original Petastorm's layout (pickled Unischema, rowgroup counts
   and a ``label`` index, written with throwaway ``petastorm`` modules) and
   phase 6's training path from it for 16 steps: the legacy schema, index
   and rows read, B2, B3 and B1 once a step, each batch also resized by
   cubic, Lanczos 3, Lanczos 5 and nearest in turn (4 launches each), phase
   6's labels and sums, and every delivered image equal byte for byte to the
   same read of the port's format; (c) determinism-matrix cells feeding
   ``CudaDataLoader`` over phase 6's dataset (4 threads, 3 processes with
   two workers killed, an in-process service fleet): one ``content_crc``
   and stream digest; (d) ``examples/spark_converter/convert_and_feed_cuda``
   over the mocked Spark DataFrame on the card;
34. the throughput harness (``petastorm_tpu_torch/benchmark``) over phase 4's
   dataset: (a) ``cuda_loader_throughput`` flat out with host decode and with
   B2, then with phase 5's measured step simulated (samples, B2's launches
   between the batches consumed and those plus the prefetched ones, the
   stall share beside phase 5's input-idle share); (b) the
   ``petastorm_tpu_torch.benchmark.cli`` process with ``--method row``,
   ``batch``, ``batch --isolated`` and ``cuda --decode-device image``,
   beside phases 7 and 10; (c) ``ops_microbench`` at the JAX tool's shapes,
   its lines printed, B1, B3, B3 aa and B2 each held once to their plain
   versions on its kept outputs, its launches in the ``kernels`` line; (d)
   ``loader_microbench`` at its defaults and ``scaling`` with 1, 4 and 7
   threads and 1 and 7 processes;
35. a float feed: 1024 rows of a fixed-shape (256, 256, 3) float16 ``image``
   (``NdarrayCodec``, values in [0, 1)) and an int64 ``label``, 4 rowgroups
   of 256 (about 400 MB), through ``make_reader`` ->
   ``CudaDataLoader(batch_size=256)`` for 2 epochs (8 batches), each batch
   cropped to 224 with drawn boxes and flips (the tiled kernel's float16
   instance) and resized 256 -> 224 antialiased (the separable kernel's),
   and the same on the batch cast to float32 or bfloat16 in turn: samples/s,
   the input-wait share, each instance's launches and none of the general
   kernel, every label seen twice, every kept crop and resize equal bit for
   bit to the general kernel's float32 instance on its batch, cast back.

Then a ``wall`` line (the script's seconds so far), a ``{"kernels": [...]}``
line and, last, ``{"ok": true, "device": ...}``.
Any failed check raises, so the script exits non-zero and prints no result;
without a CUDA GPU it exits non-zero at once.  ``python3 chip_smoke.py
--service-ab`` runs no phase: it measures phase 32 (b)'s second tenant on a
thread against one in a process of its own, with and without the shared
tier (``service_tenants_ab``).
"""

import contextlib
import io
import itertools
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import torch

if __name__ == "__main__" and not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA GPU: torch.cuda.is_available() is False")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from petastorm_tpu_torch import CompressedImageCodec, Field, Schema, make_reader, write_dataset  # noqa: E402
from petastorm_tpu_torch import CompressedNdarrayCodec, ErrorPolicy, make_batch_reader  # noqa: E402
from petastorm_tpu_torch import codecs, make_converter  # noqa: E402
from petastorm_tpu_torch import pytorch as torch_adapter  # noqa: E402
from petastorm_tpu_torch import shuffle  # noqa: E402
from petastorm_tpu_torch.batch import ColumnBatch  # noqa: E402
from petastorm_tpu_torch.checkpoint import (make_checkpoint_manager, restore_checkpoint,  # noqa: E402
                                            resume_reader_kwargs, save_checkpoint)
from petastorm_tpu_torch.cuda import build, device_buffer  # noqa: E402
from petastorm_tpu_torch.cuda.loader import VALID_ROWS, CudaDataLoader  # noqa: E402
from petastorm_tpu_torch.etl.indexing import SingleFieldIndexer, build_rowgroup_index  # noqa: E402
from petastorm_tpu_torch.errors import CircuitOpenError, ErrorBudgetExceededError  # noqa: E402
from petastorm_tpu_torch.etl.generate_metadata import generate_metadata  # noqa: E402
from petastorm_tpu_torch.etl.metadata import open_dataset  # noqa: E402
from petastorm_tpu_torch.etl.writer import materialize_dataset, stamp_dataset_metadata  # noqa: E402
from petastorm_tpu_torch.examples.hello_world import generate_dataset as hello_generate  # noqa: E402
from petastorm_tpu_torch.examples.hello_world import read_dataset as hello_read  # noqa: E402
from petastorm_tpu_torch.examples.imagenet import train_resnet_cuda as trainer  # noqa: E402
from petastorm_tpu_torch.examples.long_context import train_ring_attention_cuda as longctx  # noqa: E402,E501
from petastorm_tpu_torch.examples.mnist import train_mnist_cuda as mnist  # noqa: E402
from petastorm_tpu_torch.examples.preemption import train_with_preemption_cuda as preemption  # noqa: E402
from petastorm_tpu_torch.models import ResNet50  # noqa: E402
from petastorm_tpu_torch.ngram import NGram  # noqa: E402
from petastorm_tpu_torch.native import build as native_build  # noqa: E402
from petastorm_tpu_torch.native import image as native_image  # noqa: E402
from petastorm_tpu_torch.ops import augment, jpeg, normalize  # noqa: E402
from petastorm_tpu_torch.ops import ring_attention as ring_ops  # noqa: E402
from petastorm_tpu_torch.parallel import launch, selfcheck  # noqa: E402
from petastorm_tpu_torch.plan import WorkItem  # noqa: E402
from petastorm_tpu_torch.predicates import in_pseudorandom_split, in_set  # noqa: E402
from petastorm_tpu_torch.selectors import SingleIndexSelector  # noqa: E402
from petastorm_tpu_torch.pool import PipelineStallError  # noqa: E402
from petastorm_tpu_torch.autotune import AutotunePolicy  # noqa: E402
from petastorm_tpu_torch.cache_shared import SharedWarmCache  # noqa: E402
from petastorm_tpu_torch.telemetry import Telemetry, dominant_stage  # noqa: E402
from petastorm_tpu_torch.telemetry import sampler as telemetry_sampler  # noqa: E402
from petastorm_tpu_torch import interop  # noqa: E402
from petastorm_tpu_torch.etl.indexing import get_row_group_indexes  # noqa: E402
from petastorm_tpu_torch.examples.spark_converter import convert_and_feed_cuda  # noqa: E402
from petastorm_tpu_torch.test_util import matrix  # noqa: E402
from petastorm_tpu_torch.test_util.chaos import ChaosSpec  # noqa: E402
from petastorm_tpu_torch.test_util.legacy_petastorm import make_legacy_dataset  # noqa: E402
from petastorm_tpu_torch.test_util.latency_fs import latent_filesystem  # noqa: E402
from petastorm_tpu_torch.sequence import PackedSequenceReader, make_sequence_reader  # noqa: E402
from petastorm_tpu_torch.sequence import (SequencePacker, iter_documents,  # noqa: E402
                                          iter_packed_blocks, make_mixed_sequence_reader,
                                          make_packed_sequence_loader, packed_stream_digest,
                                          token_field)
from petastorm_tpu_torch.transform import TransformSpec, transform_cache_info  # noqa: E402
from petastorm_tpu_torch.weighted_sampling import WeightedSamplingReader  # noqa: E402
from petastorm_tpu_torch.worker import RowGroupDecoderWorker  # noqa: E402
from petastorm_tpu_torch.benchmark import ops_microbench  # noqa: E402
from petastorm_tpu_torch.benchmark import scaling as benchmark_scaling  # noqa: E402
from petastorm_tpu_torch.benchmark import throughput as benchmark_throughput  # noqa: E402
from petastorm_tpu_torch.benchmark.dummy_reader import loader_microbench  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
F32_3XTF32_FLOPS_PER_S = 495e12 / 3  # float32-accurate products as 3 TF32 tensor-core ones
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
N_ROWS, ROWS_PER_GROUP, BATCH, WARMUP_STEPS = 4096, 256, 256, 2
RATE_EPOCHS = 4               # phases 7 and 10: epochs read, 64 rowgroups
ROI = ("random", 160, 160)    # phase 7: the decode_roi read
DRAINED_FROM = 32             # phase 10: batches after this one read a drained window
SHUFFLE_CAPACITY = 2048        # phases 8-9: rows in the host shuffle buffer
SCAN_K = 4                     # phase 11: training steps a stacked unit and a graph replay
CHECKPOINT_AFTER = 6           # phase 12: steps trained before the drain
DEVICE_SHUFFLE_CAPACITY = 8    # phase 13: batches in the device shuffle buffer (2048 rows)
CACHE_EPOCHS = 3               # phase 14: epochs trained from one warm cache
MIX_ROWS, MIX_WEIGHTS, MIX_SEED = 2048, (0.75, 0.25), 17  # phase 17: the second corpus, the mix
CLIP_LEN, CLIPS_PER_GROUP, FRAME_GROUPS = 64, 4, 16      # phase 18: the frame dataset
CLIP_GAP, NGRAM_LEN, NGRAM_BATCH = 1000, 4, 64           # phase 18: gaps, window, batch
PARTITIONS, POISON_CELL = 4, 5  # phases 19-20: splits of phase 4's rows, the cut JPEG cell
TOKEN_DOCS, TOKEN_GROUP = (24576, 6144), 512   # phase 23: documents a corpus, rowgroup rows
TOKEN_WEIGHTS, TOKEN_SEED = (0.8, 0.2), 7         # phase 23: the mix and its one seed
TOKEN_SEQ_LEN, TOKEN_BATCH = 2048, 8              # phase 23: packed rows and their batch
TOKEN_MEDIAN, TOKEN_SIGMA, TOKEN_MAX = 512, 0.7, 16384  # phase 23: document lengths
TOKEN_VOCAB = 50257                               # phase 23: GPT-2's vocabulary
MNIST_ROWS, MNIST_BATCH = 60000, 32               # phase 24: MNIST's training size, batch
MNIST_RESIDENT_STEPS = 500                        # phase 24: steps timed on a resident batch
PREEMPT_ROWS = 512                                # phase 24: the preemption example's rows
B4_SHAPE = (2, 32, 2048, 128)   # phase 3: a ring block of the phase-26 trainer (B, H, S/2, D)
LC_HEADS, LC_HEAD_DIM, LC_VOCAB = 32, 128, 32000  # phase 26: Llama-2-7B's attention widths
LC_SEQ, LC_BATCH, LC_ROWS = 4096, 2, 16           # phase 26: its context, global batch, rows
LC_WARMUP, LC_TIMED, CP_RANKS = 1, 3, 2           # phase 26: steps, ranks on the seq dimension
CHILD_TIMEOUT_S = 300                             # phases 25-27: a child's time limit
SHUFFLE_RANKS, MESH2D_SHAPE = 4, (2, 2)           # phase 25: the JAX checks' device counts
PACKED_SEQ, PACKED_BATCH, PACKED_SEED = 2048, 8, 11  # phase 25: the packed loader on a mesh
DP_RANKS, DP_BATCH, DP_WARMUP, DP_TIMED = 2, 256, 2, 4  # phase 27: the data-parallel trainer
REMOTE_LATENCY_S = 0.02                           # phase 28: a request's injected latency
REMOTE_FAIL_READS, REMOTE_FAIL_OPENS = 2, 2       # phase 28: the first reads, opens failing
CIRCUIT_BOUND_S = 10.0                            # phase 28: a dead store's CircuitOpenError
CHAOS_DEADLINE_S, CHAOS_STALL_S = 5.0, 5.0        # phase 30: item deadline, stall abort
CHAOS_SLOW_S, CHAOS_HEDGE_S = 3.0, 1.0            # phase 30: the slow item, the hedge age
CHAOS_HANG, CHAOS_KILL, CHAOS_SLOW = 5, 9, 7      # phase 30: the ordinals hit
CHAOS_HANG_S = 600.0                              # phase 30: a hang, "forever"
SIDE = 224
MAIN_SHAPE = (BATCH, SIDE, SIDE, 3)


def phase(name, **fields):
    print(json.dumps({"phase": name, **fields}), flush=True)


def check_native_decode(stats, images, what, kind="batch"):
    """The reader's native decode counters after ``images`` images: all of
    them through the batched native call of ``kind`` (``batch``: full
    decode, ``roi``: crop windows, ``coef_batch``: entropy only), none per
    cell or by another call.  Returns the counters."""
    want = dict.fromkeys(stats, 0)
    want[f"{kind}_images"] = images
    want[f"{kind}_calls"] = stats[f"{kind}_calls"]
    if stats != want or not stats[f"{kind}_calls"]:
        raise AssertionError(f"{what}: native decode counters {stats}, expected {images}"
                             f" {kind} images and no other decode")
    return stats


def time_ms(fn, samples=21, launches=10, warmup=3):
    """Median over ``samples`` of the mean time of ``launches`` back-to-back
    launches between two CUDA events, after warm-up (back to back, the card
    does not wait on the host's launch overhead)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return float(np.median(times))


def captured(fn, launches):
    """A CUDA graph of ``launches`` calls of ``fn`` (after a warm-up call):
    replaying it runs the same kernel launches without the wrapper's host
    work between them, which a kernel shorter than that work would wait on."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(launches):
            fn()
    torch.cuda.synchronize()
    return graph


def time_graph_ms(fn, samples=21, launches=10):
    """:func:`time_ms` of ``launches`` back-to-back launches replayed from a
    CUDA graph (see :func:`captured`), per launch."""
    graph = captured(fn, launches)
    return time_ms(graph.replay, samples=samples, launches=1) / launches


def time_cold_ms(fn, samples=21, flush_bytes=128 << 20):
    """Median over ``samples`` of one launch (replayed from a CUDA graph)
    between two CUDA events, each after writing a ``flush_bytes`` buffer
    (more than the 50 MB L2), so that the launch finds its inputs in device
    memory only."""
    graph = captured(fn, 1)
    flush = torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
    times = []
    for i in range(samples):
        flush.fill_(i & 0xFF)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def ulp(x, mantissa_bits):
    exp = torch.floor(torch.log2(torch.clamp(x.abs(), min=2.0 ** -126)))
    return torch.pow(2.0, exp - mantissa_bits)


def check_normalize(x, mean, std, out_dtype, got=None):
    """Kernel vs plain version; bound: 2 float32 ulp at max(|out|, |bias|)
    (FMA contraction), plus 1 ulp of a narrower output type at |out|.
    ``got``: the kernel's output on ``x`` when the caller has it already."""
    scale, bias = normalize.channel_constants(mean, std, x.shape[-1])
    if got is None:
        got = normalize.normalize_images(x, mean, std, out_dtype)
    got = got.float()
    want = normalize._normalize_reference(x, scale, bias, out_dtype).float()
    torch.cuda.synchronize()
    b = torch.from_numpy(np.abs(bias)).to(x.device)
    bound = 2 * ulp(torch.maximum(want.abs(), b), 23)
    if out_dtype != torch.float32:
        bound = bound + ulp(want, {torch.bfloat16: 7, torch.float16: 10}[out_dtype])
    err = (got - want).abs()
    if not bool((err <= bound).all()):
        raise AssertionError(f"normalize kernel disagrees at {tuple(x.shape)} {out_dtype}:"
                             f" max err {err.max().item()}")
    return err.max().item()


def check_resized_crop(x, out_hw, antialias, gen, scale=(0.08, 1.0), flipped=True):
    """Kernel vs plain version on drawn boxes and flips (see
    :func:`check_resample`).  Returns (max LSB difference, share of bytes
    differing, the draws)."""
    n, h, w, _ = x.shape
    boxes = augment.draw_crop_boxes(n, h, w, gen, scale=scale, device="cuda")
    flips = augment.draw_flips(n, gen, "cuda") if flipped else None
    params = augment.crop_params(boxes, out_hw)
    got = augment.random_resized_crop(x, None, out_hw, antialias=antialias, boxes=boxes,
                                      flips=flips)
    return (*check_resample(got, x, params, flips, out_hw, antialias), (boxes, params, flips))


def check_resample(got, x, params, flips, out_hw, antialias):
    """A resample from the path's kernel (tiled without antialias, the
    antialiased tiled kernel with it) vs the general kernel on the same
    inputs, which it must equal on every byte, and vs the plain version;
    bound there: at most 1 LSB and at most 0.1 % of bytes differing (same
    float32 weights, products summed in another order, which moves a byte
    only at a .5 boundary).  Returns (max LSB difference, share differing)."""
    what = f"{tuple(x.shape)} -> {out_hw} antialias={antialias}"
    general = augment.launch_resized_crop(x, params, flips, out_hw, antialias, kernel="general")
    differing = int((got != general).sum())
    if differing:
        raise AssertionError(f"resized-crop kernel and the general kernel differ at {what}:"
                             f" {differing} bytes")
    want = augment._resized_crop_reference(x, params, flips, out_hw, antialias)
    return within_lsb(got, want, what)


def within_lsb(got, want, what):
    diff = (got.int() - want.int()).abs()
    err, share = int(diff.max()), float((diff > 0).double().mean())
    if err > 1 or share > 1e-3:
        raise AssertionError(f"resized-crop kernel disagrees at {what}:"
                             f" max {err} LSB, {share:.2e} of bytes differ")
    return err, share


def check_other_dtypes(x, boxes, flips):
    """Images that are not uint8 through random_resized_crop and resize_images
    on the card (float32, float16 and bfloat16 in the tiled and separable
    kernels' own instances, int16 through their float32 instance; the
    general kernel never) against the plain version; bound: float32 within
    8 float32 ulp of 256 (the same weights, sums in other orders), a
    narrower type one of its ulps at 255 more, an integer type 1.  Returns
    the largest difference by dtype."""
    bounds = {torch.float32: 8 * 2.0 ** -15, torch.float16: 0.125 + 8 * 2.0 ** -15,
              torch.bfloat16: 1.0 + 8 * 2.0 ** -15, torch.int16: 1.0}
    n, h, w, _ = x.shape
    out_hw = (SIDE // 2, SIDE // 3)
    params = augment.crop_params(boxes, out_hw)
    inv = torch.tensor([1.0 / (out_hw[0] / h), 0.0, 1.0 / (out_hw[1] / w), 0.0],
                       device=x.device).expand(n, 4)  # as resize_images
    errs = {}
    for dtype, bound in bounds.items():
        xd = x.to(dtype)
        for antialias in (False, True):
            k = augment.resized_crop_kernel
            counters = ("launches_general", "launches_aa" if antialias else "launches_tiled",
                        f"launches_{'separable' if antialias else 'tiled'}_"
                        f"{augment.ELEMENTS.get(dtype, 'f32')}")
            before = [getattr(k, name) for name in counters]
            got = augment.random_resized_crop(xd, None, out_hw, antialias=antialias,
                                              boxes=boxes, flips=flips)
            resized = augment.resize_images(xd, out_hw, antialias=antialias)
            took = [getattr(k, name) - b for name, b in zip(counters, before)]
            if took != [0, 2, 2]:
                raise AssertionError(f"{dtype} images, antialias={antialias}: launches of"
                                     f" {counters} {took}, expected [0, 2, 2]")
            for out, want in (
                    (got, augment._resized_crop_reference(xd, params, flips, out_hw, antialias)),
                    (resized, augment._resized_crop_reference(xd, inv, None, out_hw, antialias))):
                err = (out.double() - want.double()).abs().max().item()
                if out.dtype != dtype or not err <= bound:
                    raise AssertionError(f"{dtype} resample disagrees with the plain version:"
                                         f" {out.dtype}, max err {err} (bound {bound})")
                errs[str(dtype)] = max(errs.get(str(dtype), 0.0), err)
    return errs


def resample_bound(x, params, out_hw, antialias, method="linear"):
    """Bytes the resample needs (each image's source rows x columns with a
    nonzero weight, x C x the element size, read once, and the output, of
    the input's dtype, written once) and operations: 2 per multiply-add of
    the separable form over the nonzero taps, per image in the cheaper of
    its two orders (rows first: each output row's taps over the source
    columns used, then each output pixel's column taps; or columns first),
    x C.  Returns (bound ms, "bytes" or "operations", read, written, flops)."""
    n, h, w, c = x.shape
    oh, ow = out_hw
    wy = augment._weight_mats(h, oh, params[:, 0], params[:, 1], antialias, method) != 0
    wx = augment._weight_mats(w, ow, params[:, 2], params[:, 3], antialias, method) != 0
    rows_used, cols_used = wy.any(2).sum(1).double(), wx.any(2).sum(1).double()
    read = (rows_used * cols_used).sum().item() * c * x.element_size()
    written = n * oh * ow * c * x.element_size()
    taps_y, taps_x = wy.sum((1, 2)).double(), wx.sum((1, 2)).double()
    rows_first = taps_y * cols_used + oh * taps_x
    cols_first = taps_x * rows_used + ow * taps_y
    flops = 2 * c * torch.minimum(rows_first, cols_first).sum().item()
    bytes_ms, ops_ms = 1e3 * (read + written) / HBM_BYTES_PER_S, 1e3 * flops / F32_FLOPS_PER_S
    return (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations",
            read, written, flops)


def resized_crop_entry(gen):
    """B3 at the training step's shape: the tiled kernel (no antialias) held
    to the general kernel byte for byte and both to the plain version, on the
    main shape and ragged, unaligned and downscaled ones; its time against
    the general kernel's, and its bound.  Then the antialiased entry."""
    checks = {}
    for shape, out_hw, antialias, offset, scale, flipped in [
            (MAIN_SHAPE, (SIDE, SIDE), False, 0, (0.08, 1.0), True),
            ((7, 97, 131, 3), (50, 61), False, 0, (0.08, 1.0), True),
            ((7, 97, 131, 3), (50, 61), False, 1, (0.08, 1.0), True),  # odd byte offset
            ((6, 40, 50, 1), (21, 33), False, 0, (0.08, 1.0), True),   # C = 1
            ((6, 40, 50, 4), (19, 30), False, 1, (0.08, 1.0), False),  # C = 4, no flips
            ((5, 33, 37, 3), (20, 27), False, 0, (0.08, 1.0), True),   # rows of 111 bytes
            ((3, 300, 517, 3), (37, 301), False, 0, (0.08, 1.0), True),  # oh % 8, ow > 256
            # downscale past 8x: neighbouring pixels read source pixels far apart
            ((4, 512, 640, 3), (40, 50), False, 0, (0.5, 1.0), True),
            # C = 5: two channel chunks, the channel count known only at run time
            ((3, 20, 30, 5), (41, 7), False, 0, (0.08, 1.0), True)]:
        flat = torch.randint(0, 256, (int(np.prod(shape)) + offset,), dtype=torch.uint8,
                             device="cuda", generator=gen)
        x = flat[offset:].view(shape)
        err, share, draws = check_resized_crop(x, out_hw, antialias, gen, scale, flipped)
        checks[f"{shape}->{out_hw} antialias={antialias} offset={offset} flips={flipped}"] = {
            "max_lsb": err, "share_differing": share, "equals_general": True}
        if shape == MAIN_SHAPE:
            main_x, (boxes, params, flips), main_err = x, draws, err
    checks["float images"] = check_other_dtypes(main_x[:32], boxes[:32], flips[:32])
    n, h, w, c = main_x.shape
    out_hw = (SIDE, SIDE)
    bound_ms, bound_by, read, written, flops = resample_bound(main_x, params, out_hw, False)
    # the library yardstick: F.grid_sample on float32 NCHW with the affine
    # grid of the same boxes precomputed; the time is the grid_sample call
    # alone (not the uint8 -> float32 NCHW conversion before it, the grid,
    # or any rounding back to uint8)
    y0, x0, ch, cw = boxes.unbind(1)
    theta = torch.zeros((n, 2, 3), device="cuda")
    theta[:, 0, 0], theta[:, 0, 2] = cw / w, (2 * x0 + cw) / w - 1
    theta[:, 1, 1], theta[:, 1, 2] = ch / h, (2 * y0 + ch) / h - 1
    grid = torch.nn.functional.affine_grid(theta, (n, c) + out_hw, align_corners=False)
    x_nchw = main_x.permute(0, 3, 1, 2).float().contiguous()
    library_ms = time_ms(lambda: torch.nn.functional.grid_sample(
        x_nchw, grid, mode="bilinear", padding_mode="border", align_corners=False))
    # the tiled kernel and the PR 2 general kernel on the same inputs, in
    # turns (tiled, general, general, tiled)
    tiled = lambda: augment.resized_crop_kernel(main_x, params, flips, out_hw, False)  # noqa: E731
    general = lambda: augment.launch_resized_crop(main_x, params, flips, out_hw,  # noqa: E731
                                                  False, kernel="general")
    turns = [time_ms(tiled), time_ms(general), time_ms(general), time_ms(tiled)]
    entry = {
        "name": "resized_crop_flip_u8", "route": "cuda",
        "source": "petastorm_tpu_torch/csrc/resized_crop.cu",
        "function": "resized_crop_tiled_kernel<ElemU8>",
        "replaces": "petastorm_tpu/ops/augment.py:141",
        "max_abs_err": main_err,
        "ms": (turns[0] + turns[3]) / 2, "prev_ms": (turns[1] + turns[2]) / 2,
        "plain_ms": time_ms(lambda: augment._resized_crop_reference(main_x, params, flips,
                                                                    out_hw, False)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
    }
    phase("kernels", resized_crop_flip_u8={
        "checks": checks, "ms": entry["ms"], "prev_ms": entry["prev_ms"],
        "turns_ms_tiled_general_general_tiled": turns, "plain_ms": entry["plain_ms"],
        "bound_ms": bound_ms, "bytes_read": read, "bytes_written": written, "flops": flops,
        "library_ms": library_ms,
        "library_call": "F.grid_sample(bilinear, border, align_corners=False) on float32 NCHW,"
                        " affine grid precomputed; grid_sample alone"})
    return {"resized_crop_flip_u8": entry, "resized_crop_aa_u8": resized_crop_aa_entry(gen)}


def resized_crop_aa_entry(gen):
    """B3 with antialias (off the training path): the antialiased tiled
    kernel held to the general kernel byte for byte and both to the plain
    version at the ImageNet evaluation resize of a 256x256 batch to 224x224
    (3-5 taps per axis), at random_resized_crop(antialias=True) on the main
    shape (drawn and full-image boxes), and at ragged, unaligned and steep
    downscales; times in turns against the general kernel at the evaluation
    resize, the bound, F.interpolate, and random_resized_crop's time."""
    checks = {}
    # shape, out_hw, crop-box scale (None: resize_images' params), offset, flips
    for shape, out_hw, scale, offset, flipped in [
            ((BATCH, 256, 256, 3), (SIDE, SIDE), None, 0, False),  # the evaluation resize
            (MAIN_SHAPE, (SIDE, SIDE), (0.08, 1.0), 0, True),
            (MAIN_SHAPE, (SIDE, SIDE), (1.0, 1.0), 0, True),       # full-image boxes
            ((5, 64, 64, 1), (17, 23), (0.08, 1.0), 0, True),
            ((3, 20, 30, 5), (41, 7), (0.08, 1.0), 0, True),       # C = 5, upscaled rows
            ((6, 40, 50, 4), (19, 30), (0.08, 1.0), 1, False),     # odd byte offset
            ((3, 300, 517, 3), (37, 301), (0.08, 1.0), 0, True),
            ((4, 512, 640, 3), (40, 50), (0.5, 1.0), 0, True),     # downscale past 8x
            # 256x on one axis: a tile's span is walked in chunks
            ((2, 16, 4096, 3), (16, 16), None, 0, True)]:
        flat = torch.randint(0, 256, (int(np.prod(shape)) + offset,), dtype=torch.uint8,
                             device="cuda", generator=gen)
        x = flat[offset:].view(shape)
        n, h, w, _ = shape
        if scale is None:
            inv = [1.0 / (out_hw[0] / h), 0.0, 1.0 / (out_hw[1] / w), 0.0]  # as resize_images
            params = torch.tensor(inv, device="cuda").expand(n, 4)
            flips = augment.draw_flips(n, gen, "cuda") if flipped else None
            got = (augment.resize_images(x, out_hw, antialias=True) if flips is None else
                   augment.resized_crop_kernel(x, params, flips, out_hw, True))
            err, share = check_resample(got, x, params, flips, out_hw, True)
        else:
            err, share, (boxes, params, flips) = check_resized_crop(x, out_hw, True, gen, scale,
                                                                    flipped)
        checks[f"{shape}->{out_hw} boxes={scale or 'resize'} offset={offset} flips={flipped}"] = {
            "max_lsb": err, "share_differing": share, "equals_general": True}
        if shape == (BATCH, 256, 256, 3):
            eval_x, eval_params, eval_err, eval_share = x, params, err, share
        elif shape == MAIN_SHAPE and scale == (0.08, 1.0):
            rrc = (x, boxes, flips)
    x, params, out_hw = eval_x, eval_params, (SIDE, SIDE)
    bound_ms, bound_by, read, written, flops = resample_bound(x, params, out_hw, True)
    # the library yardstick: F.interpolate's antialiased bilinear resize (the
    # same triangle filter) on float32 NCHW, the call alone
    x_nchw = x.permute(0, 3, 1, 2).float().contiguous()
    library_ms = time_ms(lambda: torch.nn.functional.interpolate(
        x_nchw, size=out_hw, mode="bilinear", antialias=True, align_corners=False))
    # the antialiased tiled kernel and the general kernel through the
    # wrapper on the same inputs (params on the card), in turns (new,
    # general, general, new); then the entry point, which makes the params
    params = params.contiguous()
    new = lambda: augment.resized_crop_kernel(x, params, None, out_hw, True)  # noqa: E731
    general = lambda: augment.launch_resized_crop(x, params, None, out_hw, True,  # noqa: E731
                                                  kernel="general")
    turns = [time_ms(new), time_ms(general), time_ms(general), time_ms(new)]
    resize_ms = time_ms(lambda: augment.resize_images(x, out_hw, antialias=True))
    rrc_x, rrc_boxes, rrc_flips = rrc
    rrc_ms = time_ms(lambda: augment.random_resized_crop(rrc_x, None, out_hw, antialias=True,
                                                         boxes=rrc_boxes, flips=rrc_flips))
    entry = {
        "name": "resized_crop_aa_u8", "route": "cuda",
        "source": "petastorm_tpu_torch/csrc/resized_crop.cu",
        "function": "resample_separable_kernel<ElemU8, ...> after resample_axes_kernel<linear>",
        "replaces": "petastorm_tpu/ops/augment.py:141",
        "max_abs_err": eval_err,
        "ms": (turns[0] + turns[3]) / 2, "prev_ms": (turns[1] + turns[2]) / 2,
        "plain_ms": time_ms(lambda: augment._resized_crop_reference(x, params, None, out_hw,
                                                                    True)),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
    }
    phase("kernels", resized_crop_aa_u8={
        "checks": checks, "shape": list(x.shape), "out_hw": list(out_hw),
        "plan": augment.aa_launch_plan(*x.shape[1:], *out_hw)._asdict(),
        "max_lsb": eval_err, "share_differing": eval_share, "ms": entry["ms"],
        "prev_ms": entry["prev_ms"], "turns_ms_new_general_general_new": turns,
        "plain_ms": entry["plain_ms"], "bound_ms": bound_ms, "bytes_read": read,
        "bytes_written": written, "flops": flops, "library_ms": library_ms,
        "library_call": "F.interpolate(bilinear, antialias=True) on float32 NCHW, the call alone",
        "resize_images_ms": resize_ms, "random_resized_crop_aa_ms": rrc_ms,
        "random_resized_crop_aa_shape": list(rrc_x.shape)})
    return entry


FLOAT_DTYPES = (torch.float32, torch.float16, torch.bfloat16)  # phase 3: the float instances
FLOAT_METHODS = ("cubic", "lanczos3", "lanczos5")    # phase 3: timed at phase 33 (b)'s shape
FLOAT_EVAL_SIDE = 160                                # phase 3: that shape's output side
# phase 3: ragged, unaligned and steep float cases: shape, out_hw, crop-box scale (None:
# resize_images' params), element offset, flips
FLOAT_EDGE_CASES = (
    ((7, 97, 131, 3), (50, 61), (0.08, 1.0), 1, True),   # one element off alignment
    ((6, 40, 50, 1), (21, 33), (0.08, 1.0), 0, True),    # C = 1
    ((6, 40, 50, 4), (19, 30), (0.08, 1.0), 1, False),   # C = 4, no flips
    ((5, 33, 37, 3), (20, 27), (0.08, 1.0), 0, True),    # odd rows
    ((3, 300, 517, 3), (37, 301), (0.08, 1.0), 0, True),  # oh % 8, ow > 256
    ((4, 512, 640, 3), (40, 50), (0.5, 1.0), 0, True),   # downscale past 8x
    ((3, 20, 30, 5), (41, 7), (0.08, 1.0), 0, True),     # C = 5: two channel groups
    ((2, 16, 4096, 3), (16, 16), None, 0, True))         # 256x on one axis: span chunks


def float_oracle(x, params, flips, out_hw, antialias, method="linear"):
    """The general kernel's float32 instance on ``x`` as float32, cast back
    to ``x``'s dtype: what a float instance must give bit for bit."""
    return augment.launch_resized_crop(x.float().contiguous(), params, flips, out_hw, antialias,
                                       kernel="general", method=method).to(x.dtype)


def same_bits(got, want, what):
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} against the oracle's"
                             f" {want.dtype} {tuple(want.shape)}")
    differing = int((got.contiguous().reshape(-1).view(torch.uint8)
                     != want.contiguous().reshape(-1).view(torch.uint8)).sum())
    if differing:
        raise AssertionError(f"{what}: {differing} bytes differ from the general kernel's"
                             f" float32 instance")


def hold_float_to_plain(got, x, params, flips, out_hw, antialias, method, what):
    """A float instance's result against the plain version on the same
    inputs, within today's bounds: float32 within 8 float32 ulp of 256 for
    bilinear (check_other_dtypes) and 1e-5 of 256 for the other filters
    (hold_to_plain); float16 and bfloat16 one ulp of the type at
    max(|value|, 255) more.  Returns the largest difference."""
    want = augment._resized_crop_reference(x, params.expand(x.shape[0], 4), flips, out_hw,
                                           antialias, method).double()
    bound = torch.full_like(want, 8 * 2.0 ** -15 if method == "linear" else 1e-5 * 256)
    if x.dtype != torch.float32:
        bound += ulp(torch.clamp(want.abs(), min=255.0),
                     {torch.float16: 10, torch.bfloat16: 7}[x.dtype])
    err = (got.double() - want).abs()
    if not bool((err <= bound).all()):
        raise AssertionError(f"{what}: max err {err.max().item()} against the plain version")
    return err.max().item()


def float_resample_entries(gen):
    """B3's float instances in phase 3: the tiled kernel (random_resized_crop
    over MAIN_SHAPE -> 224 with drawn boxes and flips) and the separable
    kernel (the 256 -> 224 evaluation resize, bilinear antialiased; cubic,
    Lanczos 3 and Lanczos 5 at phase 33 (b)'s (256, 224, 224, 3) -> 160
    antialiased) on float32, float16 and bfloat16 images holding the same
    values of [0, 255): each equal bit for bit to the general kernel's
    float32 instance (cast back for the 16-bit types) and held to the plain
    version; timed in turns against that instance on the same values (new,
    general, general, new); the bound at the element size; beside them
    F.grid_sample and F.interpolate(antialias=True) on the float32 tensor.
    Then FLOAT_EDGE_CASES, every filter and both antialias settings, bit for
    bit.  Returns the kernels line's entries (launches filled by phase 35)."""
    main32 = torch.rand(MAIN_SHAPE, device="cuda", generator=gen) * 255
    big32 = torch.rand((BATCH, 256, 256, 3), device="cuda", generator=gen) * 255
    n = BATCH
    boxes = augment.draw_crop_boxes(n, SIDE, SIDE, gen, device="cuda")
    flips = augment.draw_flips(n, gen, "cuda")
    crop = augment.crop_params(boxes, (SIDE, SIDE))

    def inv(h, side):  # resize_images' params, one row for every image
        return torch.tensor([[1.0 / (side / h), 0.0, 1.0 / (side / h), 0.0]], device="cuda")

    # case: (source, params, flips, out_hw, antialias, method)
    cases = {"crop": (main32, crop, flips, (SIDE, SIDE), False, "linear"),
             "eval": (big32, inv(256, SIDE), None, (SIDE, SIDE), True, "linear"),
             **{m: (main32, inv(SIDE, FLOAT_EVAL_SIDE), None,
                    (FLOAT_EVAL_SIDE, FLOAT_EVAL_SIDE), True, m) for m in FLOAT_METHODS}}
    # the library yardsticks on the float32 tensors (the calls alone)
    y0, x0, ch, cw = boxes.unbind(1)
    theta = torch.zeros((n, 2, 3), device="cuda")
    theta[:, 0, 0], theta[:, 0, 2] = cw / SIDE, (2 * x0 + cw) / SIDE - 1
    theta[:, 1, 1], theta[:, 1, 2] = ch / SIDE, (2 * y0 + ch) / SIDE - 1
    grid = torch.nn.functional.affine_grid(theta, (n, 3, SIDE, SIDE), align_corners=False)
    main_nchw = main32.permute(0, 3, 1, 2).contiguous()
    big_nchw = big32.permute(0, 3, 1, 2).contiguous()
    library = {
        "crop": time_ms(lambda: torch.nn.functional.grid_sample(
            main_nchw, grid, mode="bilinear", padding_mode="border", align_corners=False)),
        "eval": time_ms(lambda: torch.nn.functional.interpolate(
            big_nchw, size=(SIDE, SIDE), mode="bilinear", antialias=True, align_corners=False))}
    del main_nchw, big_nchw, grid
    results, entries = {}, {}
    for dtype in FLOAT_DTYPES:
        element = augment.ELEMENTS[dtype]
        for case, (src32, params, fl, out_hw, antialias, method) in cases.items():
            x = src32.to(dtype)
            what = f"phase 3, {element} {case}"
            kernel = augment.resample_route(dtype, method, antialias)[0]
            new = lambda x=x, p=params, f=fl, hw=out_hw, a=antialias, m=method: (  # noqa: E731
                augment.resized_crop_kernel(x, p, f, hw, a, m))
            x_general = x.float()  # the general kernel on the same values, params a row an image
            p_general = params.expand(n, 4).contiguous()
            def general(xg=x_general, p=p_general, f=fl, hw=out_hw, a=antialias, m=method):
                return augment.launch_resized_crop(xg, p, f, hw, a, kernel="general", method=m)
            got = new()
            same_bits(got, general().to(dtype), what)
            err = hold_float_to_plain(got, x, params, fl, out_hw, antialias, method, what)
            timing = dict(samples=11, launches=5, warmup=2)
            turns = [time_ms(new, **timing), time_ms(general, **timing),
                     time_ms(general, **timing), time_ms(new, **timing)]
            bound_ms, bound_by, read, written, flops = resample_bound(x, p_general, out_hw,
                                                                      antialias, method)
            plain = lambda x=x, p=p_general, f=fl, hw=out_hw, a=antialias, m=method: (  # noqa: E731
                augment._resized_crop_reference(x, p, f, hw, a, m))
            results[f"{element} {case}"] = {
                "kernel": kernel, "shape": list(x.shape), "out_hw": list(out_hw),
                "method": method, "antialias": antialias, "equals_general_f32": True,
                "max_abs_err": err, "ms": (turns[0] + turns[3]) / 2,
                "general_f32_ms": (turns[1] + turns[2]) / 2,
                "turns_ms_new_general_general_new": turns,
                "plain_ms": time_ms(plain, samples=3, launches=1, warmup=1),
                "bound_ms": bound_ms, "bound_by": bound_by, "bytes_read": read,
                "bytes_written": written, "flops": flops, "library_ms": library.get(case)}
            del x, x_general
        for name, case, function in (
                (f"resized_crop_flip_{element}", "crop", f"resized_crop_tiled_kernel<Elem"
                 f"{element.upper()}>"),
                (f"resized_crop_aa_{element}", "eval", f"resample_separable_kernel<Elem"
                 f"{element.upper()}, ...> after resample_axes_kernel<linear>")):
            r = results[f"{element} {case}"]
            entries[name] = {
                "name": name, "route": "cuda",
                "source": f"petastorm_tpu_torch/csrc/resized_crop_{element}.cu",
                "function": function, "replaces": "petastorm_tpu/ops/augment.py:141",
                "launches": 0, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "general_f32_ms": r["general_f32_ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"]}
        entries[f"resized_crop_aa_{element}"]["filters"] = {
            m: {k: results[f"{element} {m}"][k] for k in ("ms", "general_f32_ms", "plain_ms",
                                                           "bound_ms", "bound_by", "max_abs_err")}
            for m in FLOAT_METHODS}
    del main32, big32
    edges = {}
    for shape, out_hw, scale, offset, flipped in FLOAT_EDGE_CASES:
        nn_, h, w, _ = shape
        flat = torch.rand(int(np.prod(shape)) + offset, device="cuda", generator=gen) * 300 - 20
        fl = augment.draw_flips(nn_, gen, "cuda") if flipped else None
        if scale is None:
            params = torch.tensor([1.0 / (out_hw[0] / h), 0.0, 1.0 / (out_hw[1] / w), 0.0],
                                  device="cuda").expand(nn_, 4)
        else:
            params = augment.crop_params(
                augment.draw_crop_boxes(nn_, h, w, gen, scale=scale, device="cuda"), out_hw)
        for dtype in FLOAT_DTYPES:
            x = flat.to(dtype)[offset:].view(shape)
            for method in ("linear",) + FLOAT_METHODS:
                for antialias in (False, True):
                    what = f"phase 3, {dtype} {method} {shape}->{out_hw} antialias={antialias}"
                    got = augment.resized_crop_kernel(x, params, fl, out_hw, antialias, method)
                    same_bits(got, float_oracle(x, params, fl, out_hw, antialias, method), what)
                    edges[what[9:]] = hold_float_to_plain(got, x, params, fl, out_hw, antialias,
                                                          method, what)
    phase("kernels", resized_crop_float={
        "cases": results, "edge_cases": edges, "values": "uniform [0, 255) as float32, cast",
        "edge_values": "uniform [-20, 280) as float32, cast",
        "library_call": {"crop": "F.grid_sample(bilinear, border, align_corners=False) on"
                                 " float32 NCHW, affine grid precomputed",
                         "eval": "F.interpolate(bilinear, antialias=True) on float32 NCHW"}})
    return entries


RESAMPLE_METHODS = ("cubic", "lanczos3", "lanczos5")   # phase 33: the separable kernel's filters
RESAMPLE_N = 256                                      # phase 33 (a): images a uint8 case
RESAMPLE_F32_N = 32                                   # phase 33 (a): images a float32 case
EVAL_SIDE = 160                                       # phase 33 (b): the evaluation resize's side
EVAL_METHODS = RESAMPLE_METHODS + ("nearest",)        # phase 33 (b): a method a batch, in turn
# phase 33 (a): ragged, unaligned and steep cases of every filter, both antialias settings:
# shape, out_hw, crop-box scale (None: resize_images' params), byte offset, flips
RESAMPLE_EDGE_CASES = (
    ((5, 64, 64, 1), (17, 23), (0.08, 1.0), 0, True),     # C = 1
    ((3, 20, 30, 5), (41, 7), (0.08, 1.0), 0, True),      # C = 5, upscaled rows
    ((6, 40, 50, 4), (19, 30), (0.08, 1.0), 1, False),    # odd byte offset
    ((3, 300, 517, 3), (37, 301), (0.08, 1.0), 0, True),  # oh % 8, ow > 256
    ((4, 512, 640, 3), (40, 50), (0.5, 1.0), 0, True),    # downscale past 8x
    ((2, 16, 4096, 3), (16, 16), None, 0, True))          # 256x on one axis: span chunks


def first_call_ms(fn):
    """One call of ``fn`` between two CUDA events: the first call of a case."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def hold_to_plain(got, want, what, float_out):
    """A phase-33 kernel result against the plain version's on the same
    inputs.  Bound: uint8 within 1 LSB on at most 1 % of bytes (the same
    float32 weights summed in another order, and the card's ``sinf`` against
    torch's ``sin`` in the last bit for Lanczos); float32 within 1e-5 of
    max|x| (256).  Returns (error, share differing)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"phase 33, {what}: {got.dtype} {tuple(got.shape)} against"
                             f" the plain version's {want.dtype} {tuple(want.shape)}")
    diff = (got.double() - want.double()).abs()
    err, share = float(diff.max()), float((diff > 0).double().mean())
    if float_out:
        if not err <= 1e-5 * 256:
            raise AssertionError(f"phase 33, {what}: max err {err} (bound {1e-5 * 256})")
    elif err > 1 or share > 0.01:
        raise AssertionError(f"phase 33, {what}: max {err} LSB, {share:.2e} of bytes differ")
    return err, share


def check_method_case(fn, general, plain, what, float_out):
    """A phase-33 (a) case: ``fn``'s first call held to ``plain`` by
    :func:`hold_to_plain`; for uint8, also equal on every byte to
    ``general`` (the general kernel's instance for the filter, the byte
    oracle), itself held to ``plain``.  Returns (error, share differing,
    first call ms, median ms)."""
    got, first = first_call_ms(fn)
    want = plain()
    torch.cuda.synchronize()
    err, share = hold_to_plain(got, want, f"(a) {what}", float_out)
    if general is not None:
        oracle = general()
        differing = int((got != oracle).sum())
        if differing:
            raise AssertionError(f"phase 33 (a), {what}: the separable kernel and the general"
                                 f" kernel differ in {differing} bytes")
        hold_to_plain(oracle, want, f"(a) {what}, the general kernel", float_out)
    return err, share, first, time_ms(fn, samples=11, launches=3, warmup=1)


def separable_edge_cases(gen):
    """Phase 33 (a)'s ragged, unaligned and steep cases: for every filter and
    both antialias settings, the separable kernel (through the entry points)
    equal to the general kernel byte for byte, both held to the plain
    version.  Returns {case: (max LSB, share differing)}."""
    checks = {}
    for shape, out_hw, scale, offset, flipped in RESAMPLE_EDGE_CASES:
        flat = torch.randint(0, 256, (int(np.prod(shape)) + offset,), dtype=torch.uint8,
                             device="cuda", generator=gen)
        x = flat[offset:].view(shape)
        n, h, w, _ = shape
        flips = augment.draw_flips(n, gen, "cuda") if flipped else None
        if scale is None:
            params = torch.tensor([1.0 / (out_hw[0] / h), 0.0, 1.0 / (out_hw[1] / w), 0.0],
                                  device="cuda").expand(n, 4)
        else:
            boxes = augment.draw_crop_boxes(n, h, w, gen, scale=scale, device="cuda")
            params = augment.crop_params(boxes, out_hw)
        for method in RESAMPLE_METHODS:
            for antialias in (False, True):
                what = f"{method} {shape}->{out_hw} antialias={antialias} offset={offset}"
                before = getattr(augment.resized_crop_kernel, f"launches_{method}")
                if scale is not None:
                    got = augment.random_resized_crop(x, None, out_hw, method=method,
                                                      antialias=antialias, boxes=boxes,
                                                      flips=flips)
                else:  # resize_images' params, with flips: the wrapper itself
                    got = augment.resized_crop_kernel(x, params, flips, out_hw, antialias,
                                                      method)
                if getattr(augment.resized_crop_kernel, f"launches_{method}") != before + 1:
                    raise AssertionError(f"phase 33 (a), {what}: the entry point did not launch"
                                         f" the separable kernel once")
                oracle = augment.launch_resized_crop(x, params, flips, out_hw, antialias,
                                                     kernel="general", method=method)
                differing = int((got != oracle).sum())
                if differing:
                    raise AssertionError(f"phase 33 (a), {what}: the separable kernel and the"
                                         f" general kernel differ in {differing} bytes")
                want = augment._resized_crop_reference(x, params, flips, out_hw, antialias,
                                                       method)
                checks[what] = hold_to_plain(got, want, f"(a) {what}", False)
    return checks


def resample_methods_entry():
    """Phase 33 (a): the separable tiled kernel with the cubic, Lanczos 3
    and Lanczos 5 filters and the nearest gather kernel against their plain
    versions on the card, and the separable kernel against the general
    kernel's instance for the filter (its byte oracle, on no path) on every
    byte: random_resized_crop over (256, 256, 256, 3) uint8 -> 224x224,
    resize_images down 256 -> 224 and up 128 -> 224, antialias off and on,
    the ragged, unaligned and steep cases of ``RESAMPLE_EDGE_CASES``, one
    float32 case a method (the general kernel's float32 instance); nearest
    down and up, uint8 and float32; and phase 33 (b)'s evaluation resize,
    (256, 224, 224, 3) -> EVAL_SIDE antialiased, where each method's
    ``kernels`` entry is timed: the separable and the general kernel in
    turns (new, general, general, new), nearest and
    ``F.interpolate(mode='nearest-exact')`` in turns from CUDA graphs.  Each case's time
    (median of CUDA-event samples, and its first call), its bound and the
    plain version's time."""
    gen = torch.Generator(device="cuda").manual_seed(33)
    big = torch.randint(0, 256, (RESAMPLE_N, 256, 256, 3), dtype=torch.uint8, device="cuda",
                        generator=gen)
    small = torch.randint(0, 256, (RESAMPLE_N, 128, 128, 3), dtype=torch.uint8, device="cuda",
                          generator=gen)
    boxes = augment.draw_crop_boxes(RESAMPLE_N, 256, 256, gen, device="cuda")
    flips = augment.draw_flips(RESAMPLE_N, gen, "cuda")
    out_hw = (SIDE, SIDE)
    crop = augment.crop_params(boxes, out_hw)

    def inv(h, n, side=SIDE):  # resize_images' params
        return torch.tensor([1.0 / (side / h), 0.0, 1.0 / (side / h), 0.0],
                            device="cuda").expand(n, 4)

    # phase 33 (b)'s evaluation resize: the delivered batch -> EVAL_SIDE, antialiased
    eval_x, eval_hw = big[:, 16:16 + SIDE, 16:16 + SIDE].contiguous(), (EVAL_SIDE, EVAL_SIDE)
    eval_params = inv(SIDE, RESAMPLE_N, EVAL_SIDE).contiguous()
    cases, entries = {}, {}
    for method in RESAMPLE_METHODS:
        for antialias in (False, True):
            runs = [("random_resized_crop", big, crop, flips, out_hw,
                     lambda m=method, a=antialias: augment.random_resized_crop(
                         big, None, out_hw, method=m, antialias=a, boxes=boxes, flips=flips)),
                    ("resize_down", big, inv(256, RESAMPLE_N), None, out_hw,
                     lambda m=method, a=antialias: augment.resize_images(
                         big, out_hw, method=m, antialias=a)),
                    ("resize_up", small, inv(128, RESAMPLE_N), None, out_hw,
                     lambda m=method, a=antialias: augment.resize_images(
                         small, out_hw, method=m, antialias=a))]
            if antialias:
                runs.append(("resize_eval", eval_x, eval_params, None, eval_hw,
                             lambda m=method: augment.resize_images(
                                 eval_x, eval_hw, method=m, antialias=True)))
            for case, x, params, fl, hw, fn in runs:
                what = f"{method} {case} antialias={antialias}"
                plain = (lambda x=x, p=params, f=fl, m=method, a=antialias, hw=hw:
                         augment._resized_crop_reference(x, p, f, hw, a, m))
                general = (lambda x=x, p=params, f=fl, m=method, a=antialias, hw=hw:
                           augment.launch_resized_crop(x, p, f, hw, a, kernel="general",
                                                       method=m))
                err, share, first, ms = check_method_case(fn, general, plain, what, False)
                bound_ms, bound_by, read, written, flops = resample_bound(x, params, hw,
                                                                          antialias, method)
                cases[what] = {"shape": list(x.shape), "max_lsb": err, "share_differing": share,
                               "equals_general": True, "first_ms": first, "ms": ms,
                               "plain_ms": time_ms(plain, samples=5, launches=1, warmup=1),
                               "bound_ms": bound_ms, "bound_by": bound_by, "bytes_read": read,
                               "bytes_written": written, "flops": flops}
        xf = big[:RESAMPLE_F32_N].float()
        what = f"{method} random_resized_crop float32"
        err, _, first, ms = check_method_case(
            lambda m=method: augment.random_resized_crop(
                xf, None, out_hw, method=m, boxes=boxes[:RESAMPLE_F32_N],
                flips=flips[:RESAMPLE_F32_N]), None,
            lambda m=method: augment._resized_crop_reference(
                xf, crop[:RESAMPLE_F32_N], flips[:RESAMPLE_F32_N], out_hw, False, m), what, True)
        cases[what] = {"shape": list(xf.shape), "max_abs_err": err, "first_ms": first, "ms": ms}
        # the separable kernel and the general kernel through the wrapper on
        # the same inputs (params on the card), in turns; the separable one,
        # as resize_images launches it, with one params row for every image
        new = lambda m=method: augment.launch_resized_crop(  # noqa: E731
            eval_x, eval_params[:1], None, eval_hw, True, kernel="aa", method=m)
        general = lambda m=method: augment.launch_resized_crop(  # noqa: E731
            eval_x, eval_params, None, eval_hw, True, kernel="general", method=m)
        turns = [time_ms(new, samples=11, launches=3, warmup=1),
                 time_ms(general, samples=11, launches=3, warmup=1),
                 time_ms(general, samples=11, launches=3, warmup=1),
                 time_ms(new, samples=11, launches=3, warmup=1)]
        main = cases[f"{method} resize_eval antialias=True"]  # the main path's shape
        main["turns_ms_new_general_general_new"] = turns
        entries[f"resample_{method}"] = {
            "name": f"resample_{method}", "route": "cuda",
            "source": "petastorm_tpu_torch/csrc/resized_crop.cu",
            "function": f"resample_separable_kernel<ElemU8, ...> after"
                        f" resample_axes_kernel<{method}>",
            "replaces": "petastorm_tpu/ops/augment.py:141",
            "max_abs_err": max(c.get("max_lsb", 0) for k, c in cases.items()
                               if k.startswith(method + " ")),
            "ms": (turns[0] + turns[3]) / 2, "general_ms": (turns[1] + turns[2]) / 2,
            "turns_ms_new_general_general_new": turns,
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "timed_case": f"{method} resize_eval antialias=True",
            # torch's bicubic is Keys with a = -0.75 (jax: -0.5) and it has
            # no Lanczos: no library call computes this function
            "library_ms": None}
    edges = separable_edge_cases(gen)
    for method in RESAMPLE_METHODS:
        entries[f"resample_{method}"]["max_abs_err"] = max(
            [entries[f"resample_{method}"]["max_abs_err"]]
            + [err for k, (err, _) in edges.items() if k.startswith(method + " ")])
    nearest = {}
    for case, x, hw in (("down", big, out_hw), ("up", small, out_hw),
                        ("down float32", big[:RESAMPLE_F32_N].float(), out_hw),
                        ("up float32", small[:RESAMPLE_F32_N].float(), out_hw),
                        ("C=5 odd rows", small[:RESAMPLE_F32_N, :, :125].reshape(
                            RESAMPLE_F32_N, 128, 75, 5), (51, 7)),
                        ("eval", eval_x, eval_hw)):
        fn = lambda x=x, hw=hw: augment.resize_images(x, hw, method="nearest")  # noqa: E731
        plain = lambda x=x, hw=hw: augment._resize_nearest_reference(x, hw)  # noqa: E731
        got, first = first_call_ms(fn)
        if not torch.equal(got, plain()):
            raise AssertionError(f"phase 33 (a), nearest {case}: the gather differs from the"
                                 " plain version")
        x_nchw = x.permute(0, 3, 1, 2).contiguous()
        library = lambda x_nchw=x_nchw, hw=hw: torch.nn.functional.interpolate(  # noqa: E731
            x_nchw, size=hw, mode="nearest-exact")
        n, h, w, c = x.shape
        # each source pixel picked is read once, each output pixel written once
        picked = (len(set(augment._nearest_offsets(h, hw[0], "cpu").tolist()))
                  * len(set(augment._nearest_offsets(w, hw[1], "cpu").tolist())))
        moved = (n * picked * c + got.numel()) * got.element_size()
        # the gather and the library call in turns (kernel, library, library,
        # kernel), replayed from CUDA graphs: the wrapper's host work (about
        # 0.03 ms) outlasts the gather, which a back-to-back run would time
        turns = [time_graph_ms(t, samples=11, launches=10) for t in (fn, library, library, fn)]
        nearest[case] = {"shape": list(x.shape), "first_ms": first,
                         "ms": (turns[0] + turns[3]) / 2,
                         "wrapper_ms": time_ms(fn, samples=11, launches=3, warmup=1),
                         "turns_ms_kernel_library_library_kernel": turns,
                         "plain_ms": time_ms(plain, samples=5, launches=1, warmup=1),
                         "bound_ms": 1e3 * moved / HBM_BYTES_PER_S, "bound_by": "bytes",
                         # its offsets are (o + 0.5) * fl(in / out), jax's ((o + 0.5) * in) / out
                         "library_picks_the_same_pixels": bool(torch.equal(
                             library().permute(0, 2, 3, 1), got)),
                         "library_ms": (turns[1] + turns[2]) / 2}
    down = nearest["eval"]  # the main path's shape
    entries["resize_nearest"] = {
        "name": "resize_nearest", "route": "cuda",
        "source": "petastorm_tpu_torch/csrc/resized_crop.cu",
        # rows of whole 16-byte words (the <4> and <1> instances take the others)
        "function": "resize_nearest_rows_kernel<16>",
        "replaces": "petastorm_tpu/ops/augment.py:121", "max_abs_err": 0,
        "ms": down["ms"], "plain_ms": down["plain_ms"], "bound_ms": down["bound_ms"],
        "bound_by": "bytes", "library_ms": down["library_ms"],
        # through the wrapper, as the gather's earlier time was taken
        "wrapper_ms": down["wrapper_ms"],
        "turns_ms_kernel_library_library_kernel": down["turns_ms_kernel_library_library_kernel"],
        "timed_case": "nearest eval"}
    phase("kernels", resample_methods={
        "cases": cases, "edge_cases": {k: {"max_lsb": e, "share_differing": s,
                                           "equals_general": True}
                                       for k, (e, s) in edges.items()},
        "plans": {m: augment.aa_launch_plan(SIDE, SIDE, 3, EVAL_SIDE, EVAL_SIDE, m,
                                            True)._asdict() for m in RESAMPLE_METHODS},
        "nearest": nearest,
        "library_call": "none for cubic/lanczos (torch's bicubic is Keys a = -0.75, jax's"
                        " a = -0.5; no Lanczos); nearest: F.interpolate(nearest-exact) on"
                        " uint8/float32 NCHW, the call alone"})
    return entries


def kernels_phase():
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for shape, dtypes in [(MAIN_SHAPE, (torch.bfloat16, torch.float32)),
                          ((7, 225, 223, 3), (torch.bfloat16, torch.float32, torch.float16)),
                          ((5, 31, 17, 1), (torch.bfloat16, torch.float32)),
                          ((3, 16, 16, 4), (torch.bfloat16, torch.float32))]:
        c = shape[-1]
        mean, std = ((MEAN, STD) if c == 3 else
                     ((0.5, 0.4, 0.3, 0.6)[:c], (0.2, 0.25, 0.3, 0.35)[:c]))
        x = torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda", generator=gen)
        flat = torch.randint(0, 256, (x.numel() + 1,), dtype=torch.uint8, device="cuda",
                             generator=gen)
        unaligned = flat[1:].view(shape)  # starts one byte past an aligned address
        for dt in dtypes:
            results[f"{shape} {dt}"] = check_normalize(x, mean, std, dt)
        results[f"{shape} unaligned bf16"] = check_normalize(unaligned, mean, std,
                                                             torch.bfloat16)
    for c in (65, 300):  # above 64 channels the constants go through a device buffer
        x = torch.randint(0, 256, (3, 7, 5, c), dtype=torch.uint8, device="cuda", generator=gen)
        mean, std = np.linspace(0.1, 0.9, c), np.linspace(0.2, 0.5, c)
        for dt in (torch.bfloat16, torch.float32):
            results[f"{tuple(x.shape)} {dt}"] = check_normalize(x, mean, std, dt)
    x = torch.randint(0, 256, MAIN_SHAPE, dtype=torch.uint8, device="cuda", generator=gen)
    try:
        normalize.normalize_images(x, MEAN, STD, out_dtype=torch.float64)
        raise AssertionError("normalize kernel accepted a float64 output")
    except TypeError:
        pass
    scale, bias = normalize.channel_constants(MEAN, STD, 3)
    n = x.numel()
    bound_ms = 1e3 * max(3 * n / HBM_BYTES_PER_S, 2 * n / F32_FLOPS_PER_S)
    entry = {
        "name": "normalize_u8", "route": "cuda",
        "source": "petastorm_tpu_torch/csrc/normalize.cu",
        "replaces": "petastorm_tpu/ops/normalize.py:44",
        "max_abs_err": results[f"{MAIN_SHAPE} {torch.bfloat16}"],
        "ms": time_ms(lambda: normalize.normalize_kernel(x, scale, bias, torch.bfloat16)),
        "plain_ms": time_ms(lambda: normalize._normalize_reference(x, scale, bias,
                                                                   torch.bfloat16)),
        "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
    }
    phase("kernels", normalize_u8={"max_abs_err": results, "ms": entry["ms"],
                                   "plain_ms": entry["plain_ms"], "bound_ms": bound_ms,
                                   "shape": list(MAIN_SHAPE), "out": "bfloat16"})
    return {"normalize_u8": entry, **resized_crop_entry(gen), **float_resample_entries(gen),
            "jpeg_decode_u8": jpeg_entry()}


def smooth_image(rng, h=SIDE, w=SIDE):
    """A smooth random field plus noise, so JPEG sizes look like photographs'."""
    import cv2

    low = rng.integers(0, 256, (7, 7, 3)).astype(np.float32)
    img = cv2.resize(low, (w, h), interpolation=cv2.INTER_CUBIC)
    img += rng.normal(0.0, 8.0, img.shape).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def jpeg_streams(rng, n, h, w, sampling=None, gray=False, progressive=False):
    """``n`` smooth images encoded by cv2 at q90 (4:2:0 unless ``sampling``
    names another cv2 factor)."""
    import cv2

    params = [int(cv2.IMWRITE_JPEG_QUALITY), 90]
    if sampling is not None:
        params += [int(cv2.IMWRITE_JPEG_SAMPLING_FACTOR), int(getattr(cv2, sampling))]
    if progressive:
        params += [int(cv2.IMWRITE_JPEG_PROGRESSIVE), 1]
    out = []
    for _ in range(n):
        img = smooth_image(rng, h, w)
        out.append(cv2.imencode(".jpeg", img[..., 0] if gray else img, params)[1].tobytes())
    return out


def cv2_decode(bufs):
    """The host route's decode of JPEG streams (cv2, RGB or grayscale)."""
    import cv2

    out = []
    for b in bufs:
        img = cv2.imdecode(np.frombuffer(b, np.uint8), cv2.IMREAD_UNCHANGED)
        out.append(img if img.ndim == 2 else cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
    return np.stack(out)


def within_cv2(got, want, plain, what):
    """B2's images against cv2's decode of the same streams.  The reference's
    bound (``tests/test_jpeg_hybrid.py:80-81``) is max 6 and mean below 1: the
    float IDCT, upsample and color against libjpeg's fixed-point ones.  Over
    a whole batch the reference's own function can pass 6 (the JAX package
    gives 7 on one value of the 38.5 M of phase 3's batch), so the max is
    held to the larger of 6 and the plain version's own distance from cv2
    on the same planes plus the 1 LSB B2 may differ from the plain version;
    the mean stays below 1."""
    diff = np.abs(np.asarray(got, np.int64) - np.asarray(want, np.int64))
    plain_max = int(np.abs(np.asarray(plain, np.int64) - np.asarray(want, np.int64)).max())
    err, mean, bound = int(diff.max()), float(diff.mean()), max(6, plain_max + 1)
    if err > bound or not mean < 1.0:
        raise AssertionError(f"JPEG decode differs from cv2 at {what}: max {err} (bound"
                             f" {bound}, the plain version's {plain_max}), mean {mean}")
    return {"max": err, "mean": mean, "plain_max": plain_max, "max_bound": bound,
            "mean_bound": 1.0}


def jpeg_bound(layout, n):
    """What B2 must move and compute for ``n`` images of ``layout`` decoded
    to uint8 with fancy upsampling: (bytes read, bytes written, float
    operations).  Read: the int16 coefficient planes and the int32 quant
    tables, once; written: the pixels, once.  Operations:
    per 8x8 block 64 dequantizing products, the separable IDCT's 2 x 512
    multiply-adds and 64 level-shift adds; per sample of a triangle step
    three (3*x, + neighbour, * 0.25); per RGB pixel eight for the color."""
    height, width = layout.height, layout.width
    max_h = max(h for h, _ in layout.sampling)
    max_v = max(v for _, v in layout.sampling)
    flops = 0
    for (h_samp, v_samp, bw, bh) in layout.components:
        flops += bh * bw * (64 + 2 * 2 * 512 + 64)
        cw = -(-width * h_samp // max_h)
        if max_v // v_samp == 2:
            flops += 3 * height * cw
        if max_h // h_samp == 2:
            flops += 3 * height * width
    channels = 3 if len(layout.components) == 3 else 1
    flops = n * (flops + (8 * height * width if channels == 3 else 0))
    blocks = sum(bh * bw for (_, _, bw, bh) in layout.components)
    read = n * (blocks * 64 * 2 + len(layout.components) * 64 * 4)
    written = n * height * width * channels
    return read, written, flops


def check_jpeg(planes, qtabs, layout, out_dtype, what):
    """B2 as the path runs it (the tiled kernel) equal to the general kernel
    on every byte (uint8) or bit (float32), and against the plain version on
    the same planes on the card.  Bound there: uint8 at most 1 LSB apart on
    at most 0.1 % of the bytes, float32 within 2e-3 (the same float32
    arithmetic, the IDCT's sums in other orders).  Returns (max difference,
    share of values differing)."""
    size = (layout.height, layout.width)
    counts = lambda: (jpeg.jpeg_decode_kernel.launches_tiled,  # noqa: E731
                      jpeg.jpeg_decode_kernel.launches_general)
    tiled, general = counts()
    got = jpeg.decode_from_layout(planes, qtabs, layout, out_dtype)
    if counts() != (tiled + 1, general):
        raise AssertionError(f"the JPEG decode at {what} did not launch B2's tiled kernel once")
    oracle = jpeg.launch_jpeg_decode(planes, qtabs, size, layout.sampling, out_dtype,
                                     kernel="general")
    bits = (lambda t: t.view(torch.int32)) if out_dtype == torch.float32 else (lambda t: t)
    if got.shape != oracle.shape or not torch.equal(bits(got), bits(oracle)):
        raise AssertionError(f"B2's tiled and general kernels differ at {what} {out_dtype}")
    want = jpeg._decode_reference(planes, qtabs, size, layout.sampling, out_dtype)
    diff = (got.double() - want.double()).abs()
    err, share = diff.max().item(), (diff > 0).double().mean().item()
    ok = err <= 1 and share <= 1e-3 if out_dtype == torch.uint8 else err <= 2e-3
    if got.dtype != out_dtype or got.shape != want.shape or not ok:
        raise AssertionError(f"JPEG decode kernel disagrees at {what} {out_dtype}: max {err},"
                             f" {share:.2e} differing, {got.dtype} {tuple(got.shape)}")
    return err, share


B2_INSTANCES = {"0": "tiled 4:2:0", "1": "tiled 4:2:2", "2": "tiled 4:4:4", "3": "tiled gray",
                "4": "tiled generic"}


def b2_compiler_facts():
    """ptxas's registers, stack and spills and the SASS instruction count of
    each kernel in ``csrc/jpeg_decode.cu`` (the tiled kernel's instances by
    the geometry they take), from the build the script made."""
    import re

    sass = build.sass_instruction_counts("jpeg_decode")
    facts = {}
    for mangled, report in build.ptxas_report("jpeg_decode").items():
        m = re.search(r"jpeg_decode_tiled_kernelILi(\d)E", mangled)
        name = B2_INSTANCES[m.group(1)] if m else "general"
        facts[name] = {**report, "sass_instructions": sass.get(mangled)}
    return facts


def jpeg_entry():
    """B2 held to its plain version on the card at the training batch's
    shape and at every geometry the route meets, on coefficient planes from
    the port's own entropy decode of cv2-encoded streams, the tiled kernel
    equal to the general one throughout; against cv2 at the main shape; the
    two kernels' times in turns (hot) and after an L2 flush (cold), the
    plain version's, and the bound."""
    rng = np.random.default_rng(1)
    checks = {}
    for name, n, (h, w), sampling, gray, progressive in [
            ("main 4:2:0", BATCH, (SIDE, SIDE), None, False, False),
            ("4:4:4", 32, (SIDE, SIDE), "IMWRITE_JPEG_SAMPLING_FACTOR_444", False, False),
            ("4:2:2", 32, (SIDE, SIDE), "IMWRITE_JPEG_SAMPLING_FACTOR_422", False, False),
            ("grayscale", 32, (SIDE, SIDE), None, True, False),
            ("37x53", 16, (37, 53), None, False, False),
            ("progressive", 32, (SIDE, SIDE), None, False, True)]:
        bufs = jpeg_streams(rng, n, h, w, sampling, gray, progressive)
        planes, qtabs, layout = native_image.read_jpeg_coefficients_column(
            bufs, nthreads=os.cpu_count() or 1)
        dp = [torch.from_numpy(p).cuda() for p in planes]
        dq = torch.from_numpy(qtabs.astype(np.int32)).cuda()
        for out_dtype in (torch.uint8, torch.float32):
            err, share = check_jpeg(dp, dq, layout, out_dtype, name)
            checks[f"{name} {tuple(planes[0].shape)} {layout.sampling} {out_dtype}"] = {
                "max_abs_err": err, "share_differing": share}
        if name == "main 4:2:0":
            main = (dp, dq, layout, bufs)
    dp, dq, layout, bufs = main
    size = (layout.height, layout.width)
    got = jpeg.decode_from_layout(dp, dq, layout).cpu().numpy()
    plain = jpeg._decode_reference(dp, dq, size, layout.sampling).cpu().numpy()
    vs_cv2 = within_cv2(got, cv2_decode(bufs), plain, "the main shape")
    main_err = checks[f"main 4:2:0 {tuple(dp[0].shape)} {layout.sampling} {torch.uint8}"]
    read, written, flops = jpeg_bound(layout, BATCH)
    bytes_ms, ops_ms = 1e3 * (read + written) / HBM_BYTES_PER_S, 1e3 * flops / F32_FLOPS_PER_S
    # the tiled kernel and the general kernel on the same planes, in
    # turns (tiled, general, general, tiled), launched from CUDA graphs (the
    # wrapper's host work per call outlasts the tiled kernel); then each
    # after an L2 flush; and back to back through the wrapper, host included
    tiled = lambda: jpeg.jpeg_decode_kernel(dp, dq, size, layout.sampling)  # noqa: E731
    general = lambda: jpeg.launch_jpeg_decode(dp, dq, size, layout.sampling,  # noqa: E731
                                              kernel="general")
    turns = [time_graph_ms(tiled), time_graph_ms(general), time_graph_ms(general),
             time_graph_ms(tiled)]
    cold = {"tiled": time_cold_ms(tiled), "general": time_cold_ms(general)}
    wrapper = {"tiled": time_ms(tiled), "general": time_ms(general)}
    bound_ms = max(bytes_ms, ops_ms)
    stacked = stacked_jpeg_entry(dp, dq, layout, torch.from_numpy(got).cuda())
    entry = {
        "name": "jpeg_decode_u8", "route": "cuda",
        "source": "petastorm_tpu_torch/csrc/jpeg_decode.cu",
        "function": "jpeg_decode_tiled_kernel",
        "replaces": "petastorm_tpu/ops/jpeg.py:103",
        "max_abs_err": main_err["max_abs_err"],
        "ms": (turns[0] + turns[3]) / 2, "prev_ms": (turns[1] + turns[2]) / 2,
        "plain_ms": time_ms(lambda: jpeg._decode_reference(dp, dq, size, layout.sampling)),
        "bound_ms": bound_ms, "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }
    phase("kernels", jpeg_decode_u8={
        "checks": checks, "equals_general": True, "shape": [BATCH, SIDE, SIDE, 3],
        "sampling": list(layout.sampling), "vs_cv2": vs_cv2, "ms": entry["ms"],
        "prev_ms": entry["prev_ms"], "turns_ms_tiled_general_general_tiled": turns,
        "share_of_bound": bound_ms / entry["ms"],
        "prev_share_of_bound": bound_ms / entry["prev_ms"],
        "timing": "10 launches replayed from a CUDA graph between CUDA events, median of 21",
        "cold_ms": cold["tiled"], "cold_prev_ms": cold["general"],
        "cold_method": "median of 21 single launches from a CUDA graph, each after writing a"
                       " 128 MB buffer",
        "through_wrapper_ms": wrapper["tiled"], "through_wrapper_prev_ms": wrapper["general"],
        "plan": jpeg.decode_launch_plan(BATCH, size, tuple(layout.sampling),
                                        tuple(tuple(p.shape[1:3]) for p in dp), True,
                                        jpeg._sm_count(torch.cuda.current_device()))._asdict(),
        "plain_ms": entry["plain_ms"], "bound_ms": bound_ms, "bytes_read": read,
        "bytes_written": written, "flops": flops,
        "library_call": "none: no PyTorch call computes it", "stacked": stacked})
    return entry


def stacked_jpeg_entry(dp, dq, layout, main_out):
    """B2 at phase 11's size: one launch over a stacked unit's SCAN_K x BATCH
    images (the main batch's planes repeated), each copy equal on every byte
    to the main batch's decode; its time from CUDA graphs, hot and after an
    L2 flush, and its bound."""
    size = (layout.height, layout.width)
    planes = [p.repeat(SCAN_K, 1, 1, 1) for p in dp]
    qtabs = dq.repeat(SCAN_K, 1, 1)
    fn = lambda: jpeg.jpeg_decode_kernel(planes, qtabs, size, layout.sampling)  # noqa: E731
    out = fn().view(SCAN_K, *main_out.shape)
    if not all(torch.equal(out[k], main_out) for k in range(SCAN_K)):
        raise AssertionError(f"B2 over {SCAN_K} x {BATCH} images differs from the main batch's")
    n = SCAN_K * BATCH
    read, written, flops = jpeg_bound(layout, n)
    bytes_ms, ops_ms = 1e3 * (read + written) / HBM_BYTES_PER_S, 1e3 * flops / F32_FLOPS_PER_S
    ms = time_graph_ms(fn)
    return {"images": n, "ms": ms, "cold_ms": time_cold_ms(fn),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "share_of_bound": max(bytes_ms, ops_ms) / ms, "bytes_read": read,
            "bytes_written": written, "flops": flops, "equals_main_batch": True}


def main_path_phase(tmp, kernels):
    cores = os.cpu_count() or 2
    rng = np.random.default_rng(0)
    labels = rng.permutation(N_ROWS).astype(np.int64)
    schema = Schema("ImageNetJpeg", [
        Field("label", np.int64),
        Field("image", np.uint8, (SIDE, SIDE, 3), CompressedImageCodec("jpeg", quality=90)),
    ])
    path = os.path.join(tmp, "imagenet_jpeg")
    t0 = time.perf_counter()
    write_dataset(path, schema, ({"label": int(lab), "image": smooth_image(rng)}
                                 for lab in labels),
                  row_group_size_rows=ROWS_PER_GROUP, encode_workers=cores)
    data_bytes = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
    write_s = time.perf_counter() - t0

    model = ResNet50(num_classes=1000, dtype=torch.bfloat16, device="cuda",
                     generator=torch.Generator().manual_seed(0))
    model = model.to(memory_format=torch.channels_last)
    workers = max(1, min(cores - 1, 16))
    reader = make_reader(path, workers_count=workers, shuffle_seed=0, num_epochs=1,
                         decode_placement={"image": "host"})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    normalize.normalize_kernel.launches = 0
    delivered, steps, first = [], 0, None
    with CudaDataLoader(reader, batch_size=BATCH, device="cuda") as loader, \
            torch.inference_mode():
        start = time.perf_counter()
        for batch in loader:
            logits = model(normalize.normalize_images(batch["image"], MEAN, STD))
            delivered.append(batch["label"])
            if not bool(torch.isfinite(logits).all()) or logits.shape != (BATCH, 1000):
                raise AssertionError(f"step {steps}: bad logits {tuple(logits.shape)}")
            if first is None:
                first = (batch["image"][:8].clone(), logits[:8].float().clone())
            steps += 1
            if steps == WARMUP_STEPS:
                torch.cuda.synchronize()
                timed_start, wait0 = time.perf_counter(), loader.diagnostics()["consumer_wait_s"]
        torch.cuda.synchronize()
        end = time.perf_counter()
        wait = loader.diagnostics()["consumer_wait_s"] - wait0
    launches = {"normalize_u8": normalize.normalize_kernel.launches}
    peak = torch.cuda.max_memory_allocated()
    decoded = check_native_decode(reader.decode_stats(), N_ROWS, "phase 4")

    want_steps = N_ROWS // BATCH
    if steps != want_steps:
        raise AssertionError(f"{steps} steps, expected {want_steps}")
    for name, count in launches.items():
        if count != steps:
            raise AssertionError(f"kernel {name} launched {count} times in {steps} steps")
        kernels[name]["launches"] = count
    got_labels = torch.sort(torch.cat(delivered)).values.cpu().numpy()
    if not np.array_equal(got_labels, np.sort(labels)):
        raise AssertionError("labels delivered over the epoch differ from the labels written")

    # the plain path in float32 (TF32 off) on the first images of the epoch:
    # bf16 rounds every layer, so logits agree within 5 % of the largest + 0.02
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ref_model = ResNet50(num_classes=1000, dtype=torch.float32, device="cuda",
                         generator=torch.Generator().manual_seed(0))
    scale, bias = normalize.channel_constants(MEAN, STD, 3)
    with torch.inference_mode():
        ref = ref_model(normalize._normalize_reference(first[0], scale, bias, torch.float32))
    ref_err = (first[1] - ref).abs().max().item()
    ref_tol = 0.05 * ref.abs().max().item() + 0.02
    if not ref_err <= ref_tol:
        raise AssertionError(f"bf16 logits differ from the float32 plain path by {ref_err}"
                             f" (bound {ref_tol})")

    timed = end - timed_start
    phase("main_path", steps=steps, timed_steps=steps - WARMUP_STEPS, batch=BATCH,
          workers=workers, samples_per_s=(steps - WARMUP_STEPS) * BATCH / timed,
          epoch_s=end - start, consumer_wait_share=wait / timed,
          peak_device_memory_bytes=peak, launches=launches,
          dataset_bytes=data_bytes, dataset_write_s=write_s, decode_stats=decoded,
          labels_match=True, logits_vs_f32_plain={"max_abs_err": ref_err, "bound": ref_tol})
    return path, (steps - WARMUP_STEPS) * BATCH / timed


def leaves_flat(step):
    return torch.cat([leaf.detach().flatten().double() for leaf in step.leaves])


def check_step_vs_f32_plain(images, labels, gen):
    """One bf16 step of the trainer against one float32 step of the plain
    path (plain augment, plain normalize in float32, TF32 off), both from
    the seed-0 weights and the same boxes and flips.

    Bounds.  Update: the relative error |u16 - u32| / |u32| of the flattened
    update at most 0.03, over the weights (``params``) and, apart, over the
    BatchNorm statistics (``batch_stats``), so that the statistics' 53 k
    leaves are not lost among the 25.6 M weights.  SGD-momentum's first
    update is -lr times the gradient, so this is the gradients' relative
    error: bf16 keeps 8 bits and each of the ~100 rounded layers of forward
    and backward adds about 2^-9 of it; measured on an H100: 0.0099 over the
    weights and 0.0135 over the statistics.  0.03 leaves 2-3x headroom,
    while a dropped or wrong part of the step (a wrong gradient of the
    statistics, one layer's update missing) moves it by far more.  The
    cosine of the two flattened updates is held to the bound that implies,
    sqrt(1 - 0.03^2) = 0.99955 (an update within e * |u32| of u32 makes an
    angle of at most asin(e) with it).  Loss: within 1e-3 (measured gap
    2.3e-5).  From random init every block's last BatchNorm scale is zero,
    so the loss is about ln(1000) whatever the images (6.927-6.989 over an
    epoch's batches): the loss bound guards the loss arithmetic only, and
    the update bound is the check of the step."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    n, h, w, _ = images.shape
    boxes = augment.draw_crop_boxes(n, h, w, gen, device="cuda")
    flips = augment.draw_flips(n, gen, "cuda")
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        model = ResNet50(num_classes=1000, dtype=dtype, device="cuda",
                         generator=torch.Generator().manual_seed(0))
        model = model.to(memory_format=torch.channels_last)
        step = trainer.TrainStep(model, 1000, SIDE)
        n_params = sum(p.numel() for p in model.parameters())
        before = leaves_flat(step)
        if dtype == torch.bfloat16:
            loss = step(images, labels, boxes=boxes, flips=flips)
        else:
            params = augment.crop_params(boxes, (SIDE, SIDE))
            crops = augment._resized_crop_reference(images, params, flips, (SIDE, SIDE), False)
            scale, bias = normalize.channel_constants(MEAN, STD, 3)
            x = normalize._normalize_reference(crops, scale, bias, torch.float32)
            loss = step.update(x, labels)
        out[dtype] = (float(loss), leaves_flat(step) - before)
        del model, step
    (loss16, d16), (loss32, d32) = out[torch.bfloat16], out[torch.float32]
    loss_bound, rel_bound = 1e-3, 0.03
    cosine_bound = (1 - rel_bound ** 2) ** 0.5
    rel = {name: float((d16[part] - d32[part]).norm() / d32[part].norm())
           for name, part in (("all", slice(None)), ("params", slice(0, n_params)),
                              ("batch_stats", slice(n_params, None)))}
    cosine = float(d16 @ d32 / (d16.norm() * d32.norm()))
    if not (abs(loss16 - loss32) <= loss_bound and cosine >= cosine_bound
            and rel["params"] <= rel_bound and rel["batch_stats"] <= rel_bound):
        raise AssertionError(f"bf16 step vs float32 plain step: loss {loss16} vs {loss32}"
                             f" (bound {loss_bound}), update relative errors {rel}"
                             f" (bound {rel_bound}), cosine {cosine} (bound {cosine_bound})")
    return {"loss_bf16": loss16, "loss_f32": loss32, "loss_bound": loss_bound,
            "update_rel_err": rel, "rel_err_bound": rel_bound,
            "update_cosine": cosine, "cosine_bound": cosine_bound}


def device_time_by_op(step, images, labels, steps=3, top=12):
    """Device time of ``steps`` training steps on one resident batch, by the
    op that launched it (``torch.profiler``; each kernel counted once, under
    the innermost op around its launch): (ms per step in all, the ``top`` ops
    as (name, ms per step))."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step(images, labels)
        torch.cuda.synchronize()
    times = [(e.key, e.self_device_time_total / 1e3 / steps) for e in prof.key_averages()
             if e.device_type == DeviceType.CPU and e.self_device_time_total > 0]
    times.sort(key=lambda kv: -kv[1])
    return sum(t for _, t in times), times[:top]


def train_epoch(path, decode, loader_kwargs=None, epochs=1, reader_kwargs=None,
                label_field="label", rows=None, decoded_images=None, source=None,
                on_batch=None, loader=None):
    """``epochs`` epochs (one by default) of the training path over the
    phase-4 dataset, the reader decoding with ``decode_placement={'image':
    decode}`` and taking ``reader_kwargs``, the loader taking
    ``loader_kwargs``; every kernel count set to 0 just before the run and
    read just after it.  The step trains on ``label_field`` mod 1000.  With a
    ``cache_type`` the native decode runs in the first epoch only.  A reader
    that selects rows delivers ``rows`` rows over all its epochs (full
    batches of them are trained) and decodes ``decoded_images`` images.
    ``source=(reader, parts)`` trains on ``reader`` instead (a mix), whose
    ``parts`` (its sub-readers) count the decoded images; ``loader`` (made
    over that reader) is iterated instead of a new ``CudaDataLoader``.
    ``on_batch`` is called with every delivered batch.  With
    ``decode='device-mixed'`` B2 launches once a geometry bucket, which the
    caller counts."""
    cores = os.cpu_count() or 2
    workers = max(1, min(cores - 1, 16))
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16, device="cuda",
                     generator=torch.Generator().manual_seed(0))
    model = model.to(memory_format=torch.channels_last)
    step = trainer.TrainStep(model, 1000, SIDE,
                             generator=torch.Generator(device="cuda").manual_seed(
                                 trainer.AUGMENT_SEED))
    reader_kwargs = reader_kwargs or {}
    if source is None:
        reader = make_reader(path, workers_count=workers, shuffle_seed=0, num_epochs=epochs,
                             decode_placement={"image": decode}, **reader_kwargs)
        parts = [reader]
    else:
        reader, parts = source
    steps_per_epoch = N_ROWS // BATCH
    want_steps = epochs * steps_per_epoch if rows is None else rows // BATCH
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, labels_seen, image_sums, steps, first = [], [], [], 0, None
    epoch_marks = []  # (seconds, consumer wait) at the end of each epoch
    if loader is None:
        loader = CudaDataLoader(reader, batch_size=BATCH, device="cuda", **(loader_kwargs or {}))
    with loader:
        start = time.perf_counter()
        for batch in loader:
            labels = batch[label_field] % 1000
            labels_seen.append(batch[label_field])
            image_sums.append(batch["image"].sum(dtype=torch.int64))
            if first is None:
                first = (batch["image"].clone(), labels.clone())
                flops, loss = trainer.count_flops(step, batch["image"], labels)
            else:
                loss = step(batch["image"], labels)
            losses.append(loss)
            if on_batch is not None:
                on_batch(batch)
            steps += 1
            if steps == WARMUP_STEPS:
                torch.cuda.synchronize()
                timed_start, wait0 = time.perf_counter(), loader.diagnostics()["consumer_wait_s"]
            if epochs > 1 and rows is None and steps % steps_per_epoch == 0:
                torch.cuda.synchronize()
                epoch_marks.append((time.perf_counter(), loader.diagnostics()["consumer_wait_s"]))
        torch.cuda.synchronize()
        end = time.perf_counter()
        diagnostics = loader.diagnostics()
        wait = diagnostics["consumer_wait_s"] - wait0
    launches = kernel_launch_counts()
    general_launches = launches.pop("general_resized_crop")
    general_b2 = launches.pop("general_jpeg_decode")
    losses = torch.stack(losses).float().cpu()

    if steps != want_steps:
        raise AssertionError(f"{steps} training steps ({decode} decode), expected {want_steps}")
    # every crop of the step is without antialias: the tiled kernel, never the
    # antialiased one, and no path launches the general one; B2's tiled
    # kernel once a step when the decode finishes on the card, never
    # otherwise, and B2's general kernel never
    want = {"normalize_u8": steps, "resized_crop_flip_u8": steps, "resized_crop_aa_u8": 0,
            # a geometry bucket each: the caller holds them to its buckets;
            # under the live split once a device-form batch, never a host-form one
            "jpeg_decode_u8": {"device": steps,
                               "device-mixed": launches["jpeg_decode_u8"],
                               "auto": diagnostics.get("decode_split_batches", {}).get(
                                   "device", -1)}.get(decode, 0)}
    if general_launches or general_b2:
        raise AssertionError(f"the general resized-crop and JPEG decode kernels launched"
                             f" {general_launches} and {general_b2} times in {steps} steps,"
                             f" expected 0")
    for name, count in launches.items():
        if count != want[name]:
            raise AssertionError(f"kernel {name} launched {count} times in {steps} steps"
                                 f" ({decode} decode), expected {want[name]}")
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"non-finite training loss: {losses.tolist()}")
    cached = reader_kwargs.get("cache_type", "null") != "null"
    if decoded_images is None:
        decoded_images = N_ROWS * (1 if cached else epochs)
    if (reader_kwargs.get("reader_pool_type") == "process"
            or reader_kwargs.get("service_address") is not None):
        # the workers count their decode in their own processes: the caller
        # reads the pool's transport counters, or the fleet's, instead
        decoded = None
    elif decode == "auto":
        # the live split: entropy-only decode for device-form rowgroups, the
        # full decode for host-form ones, nothing else
        decoded = parts[0].decode_stats()
        other = {k: v for k, v in decoded.items()
                 if k not in ("batch_calls", "batch_images", "coef_batch_calls",
                              "coef_batch_images") and v}
        if decoded["batch_images"] + decoded["coef_batch_images"] != decoded_images or other:
            raise AssertionError(f"training, live split: native decode counters {decoded},"
                                 f" expected {decoded_images} images in all")
    else:
        stats = [part.decode_stats() for part in parts]
        decoded = check_native_decode({k: sum(s[k] for s in stats) for k in stats[0]},
                                      decoded_images, f"training, {decode} decode",
                                      "batch" if decode == "host" else "coef_batch")
    timed = end - timed_start
    return {"step": step, "model": model, "first": first, "flops": flops,
            "labels": torch.cat(labels_seen).cpu(), "losses": losses, "steps": steps,
            "workers": workers, "launches": launches, "general_launches": general_launches,
            "peak": torch.cuda.max_memory_allocated(), "epoch_s": end - start, "timed": timed,
            "samples_per_s": (steps - WARMUP_STEPS) * BATCH / timed, "wait": wait,
            "diagnostics": diagnostics, "decode_stats": decoded,
            "digest": getattr(reader, "stream_digest", None),
            "state": reader.state_dict() if hasattr(reader, "state_dict") else None,
            "image_sums": torch.stack(image_sums).cpu(), "cache_stats": parts[0].cache_stats(),
            "timed_start": (timed_start, wait0), "epoch_marks": epoch_marks}


def reset_launch_counts():
    """Every kernel wrapper's launch count to 0."""
    ring_ops.reset_launch_counts()
    normalize.normalize_kernel.launches = 0
    for counts, names in ((augment.resized_crop_kernel, ("",) + augment.LAUNCH_COUNTERS),
                          (augment.nearest_kernel, ("",)),
                          (jpeg.jpeg_decode_kernel, ("", "_tiled", "_general"))):
        for suffix in names:
            setattr(counts, "launches" + suffix, 0)


def kernel_launch_counts():
    """Each kernel's launches since :func:`reset_launch_counts`, by its name
    in the ``kernels`` line; the general kernels' under their own names."""
    return {"normalize_u8": normalize.normalize_kernel.launches,
            "resized_crop_flip_u8": augment.resized_crop_kernel.launches_tiled,
            "resized_crop_aa_u8": augment.resized_crop_kernel.launches_aa,
            "jpeg_decode_u8": jpeg.jpeg_decode_kernel.launches_tiled,
            "general_resized_crop": augment.resized_crop_kernel.launches_general,
            "general_jpeg_decode": jpeg.jpeg_decode_kernel.launches_general}


def train_path_phase(path, kernels):
    """The training path over one epoch of the phase-4 dataset, host decode."""
    run = train_epoch(path, "host")
    for name in ("normalize_u8", "resized_crop_flip_u8", "resized_crop_aa_u8"):
        kernels[name]["launches"] = run["launches"][name]
    step, steps, timed = run["step"], run["steps"], run["timed"]
    device_ms, by_op = device_time_by_op(step, *run["first"])
    first = run.pop("first")
    del run["model"], run["step"], step

    samples_per_s = run["samples_per_s"]
    flops_per_sample = run["flops"] / BATCH
    peak_flops = trainer.measure_peak_flops("cuda")
    step_check = check_step_vs_f32_plain(*first, torch.Generator(device="cuda").manual_seed(1))
    phase("train_path", decode="host", steps=steps, timed_steps=steps - WARMUP_STEPS,
          batch=BATCH, workers=run["workers"], samples_per_s=samples_per_s,
          epoch_s=run["epoch_s"], step_ms=1e3 * timed / (steps - WARMUP_STEPS),
          consumer_wait_share=run["wait"] / timed, peak_device_memory_bytes=run["peak"],
          launches=run["launches"], general_resized_crop_launches=run["general_launches"],
          losses=run["losses"].tolist(), flops_per_sample=flops_per_sample,
          achieved_flops_per_s=flops_per_sample * samples_per_s,
          measured_peak_bf16_flops_per_s=peak_flops,
          profiled_device_ms_per_step=device_ms,
          device_busy_share=device_ms / (1e3 * timed / (steps - WARMUP_STEPS)),
          device_ms_per_step_by_op=by_op, decode_stats=run["decode_stats"],
          share_of_measured_peak=(flops_per_sample * samples_per_s / peak_flops
                                  if peak_flops else None),
          step_vs_f32_plain=step_check)
    return {"labels": run["labels"], "first_images": first[0].cpu(),
            "samples_per_s": samples_per_s, "losses": run["losses"], "digest": run["digest"],
            "image_sums": run["image_sums"], "step_s": timed / (steps - WARMUP_STEPS),
            "input_idle_share": run["wait"] / timed}


def train_path_device_decode_phase(path, kernels, host):
    """Phase 5's training path with the decode finished on the card (B2), on
    the same dataset and seeds: the same labels in the same order, and the
    first batch's images within the reference's bound (max 6, mean below 1)
    of phase 5's, which the host decoded natively with libjpeg (the bytes of
    cv2's decode: phase 7 holds the two equal)."""
    run = train_epoch(path, "device")
    kernels["jpeg_decode_u8"]["launches"] = run["launches"]["jpeg_decode_u8"]
    if not torch.equal(run["labels"], host["labels"]):
        raise AssertionError("device decode delivered other labels, or in another order,"
                             " than host decode")
    images = run["first"][0].cpu()
    if images.shape != (BATCH, SIDE, SIDE, 3) or images.dtype != torch.uint8:
        raise AssertionError(f"device decode delivered {images.dtype} {tuple(images.shape)}")
    # the plain version on the first batch's planes: the first rowgroup
    # holds the first batch (ROWS_PER_GROUP == BATCH)
    reader = make_reader(path, workers_count=1, shuffle_seed=0, num_epochs=1,
                         decode_placement={"image": "device"})
    with reader:
        first_group = next(reader.iter_batches()).slice_rows(0, BATCH)
    if not np.array_equal(first_group.columns["label"], host["labels"][:BATCH].numpy()):
        raise AssertionError("the first rowgroup is not the first batch")
    planes, qtabs, layout = native_image.unpack_coef_columns("image", first_group.columns)
    plain = jpeg._decode_reference([torch.from_numpy(p).cuda() for p in planes],
                                   torch.from_numpy(qtabs.astype(np.int32)).cuda(),
                                   (layout.height, layout.width), layout.sampling)
    vs_cv2 = within_cv2(images.numpy(), host["first_images"].numpy(), plain.cpu().numpy(),
                        "the first batch")
    steps, timed = run["steps"], run["timed"]
    phase("train_path_device_decode", decode="device", steps=steps,
          timed_steps=steps - WARMUP_STEPS, batch=BATCH, workers=run["workers"],
          samples_per_s=run["samples_per_s"], host_decode_samples_per_s=host["samples_per_s"],
          epoch_s=run["epoch_s"], step_ms=1e3 * timed / (steps - WARMUP_STEPS),
          consumer_wait_share=run["wait"] / timed, peak_device_memory_bytes=run["peak"],
          launches=run["launches"], general_resized_crop_launches=run["general_launches"],
          losses=run["losses"].tolist(), labels_match_host_order=True,
          decode_stats=run["decode_stats"], first_batch_vs_host_decode=vs_cv2)
    return {"labels": run["labels"], "samples_per_s": run["samples_per_s"],
            "first_images": images, "image_sums": run["image_sums"], "epoch_s": run["epoch_s"],
            "input_idle_share": run["wait"] / timed}


def shuffled_train_path_phase(path, device):
    """Phase 6's path with the loader's shuffle buffer: the epoch's labels as
    a multiset equal to phase 6's, in another order, and in the order the
    port's ``shuffle.iter_batched`` gives on the CPU over phase 6's labels
    in plan order (rowgroups of 256 = phase 6's batches) with the same seed
    and sizes: the buffer's draws depend on its sizes only."""
    run = train_epoch(path, "device", {"shuffling_queue_capacity": SHUFFLE_CAPACITY,
                                       "buffer_seed": 0})
    labels, plan_order = run["labels"].numpy(), device["labels"].numpy()
    if not np.array_equal(np.sort(labels), np.sort(plan_order)):
        raise AssertionError("the shuffled epoch delivered other labels than phase 6")
    if np.array_equal(labels, plan_order):
        raise AssertionError("the shuffled epoch delivered phase 6's order")
    rowgroups = (ColumnBatch({"label": plan_order[i:i + ROWS_PER_GROUP]}, ROWS_PER_GROUP)
                 for i in range(0, len(plan_order), ROWS_PER_GROUP))
    buffer = shuffle.RandomShufflingBuffer(SHUFFLE_CAPACITY, SHUFFLE_CAPACITY // 2, seed=0)
    want = np.concatenate([b.columns["label"]
                           for b in shuffle.iter_batched(rowgroups, buffer, BATCH)])
    if not np.array_equal(labels, want):
        raise AssertionError("the shuffled epoch's order differs from shuffle.iter_batched's"
                             " on the CPU")
    steps, timed, diag = run["steps"], run["timed"], run["diagnostics"]
    phase("train_path_device_decode_shuffled", decode="device",
          shuffling_queue_capacity=SHUFFLE_CAPACITY, min_after_retrieve=SHUFFLE_CAPACITY // 2,
          buffer_seed=0, steps=steps, timed_steps=steps - WARMUP_STEPS, batch=BATCH,
          workers=run["workers"], samples_per_s=run["samples_per_s"],
          unshuffled_samples_per_s=device["samples_per_s"], epoch_s=run["epoch_s"],
          step_ms=1e3 * timed / (steps - WARMUP_STEPS), consumer_wait_share=run["wait"] / timed,
          peak_device_memory_bytes=run["peak"], launches=run["launches"],
          general_resized_crop_launches=run["general_launches"],
          losses=run["losses"].tolist(),
          assemble_ms_per_batch=1e3 * diag["assemble_s"] / steps,
          transfer_ms_per_batch=1e3 * diag["transfer_s"] / steps,
          straggler_releases=diag["straggler_releases"], decode_stats=run["decode_stats"],
          labels_match_phase6_multiset=True, order_matches_cpu_shuffle=True)


def adapter_loader(path, device):
    """A reader of one epoch of the phase-4 dataset (host decode) and
    ``pytorch.BatchedDataLoader`` over it, each batch's tensors moved to
    ``device`` by its ``transform_fn``."""
    cores = os.cpu_count() or 2
    reader = make_reader(path, workers_count=max(1, min(cores - 1, 16)), shuffle_seed=0,
                         num_epochs=1, decode_placement={"image": "host"})
    return reader, torch_adapter.BatchedDataLoader(
        reader, batch_size=BATCH, shuffling_queue_capacity=SHUFFLE_CAPACITY, seed=0,
        transform_fn=lambda b: {k: v.to(device) for k, v in b.items()})


def adapter_phase(path, main_samples_per_s):
    """The reference-style torch feed (the adapter, pageable copies in its
    ``transform_fn``) into normalize and the ResNet-50 forward, against a CPU
    run of the same adapter."""
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16, device="cuda",
                     generator=torch.Generator().manual_seed(0))
    model = model.to(memory_format=torch.channels_last)
    reader, loader = adapter_loader(path, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    normalize.normalize_kernel.launches = 0
    delivered, steps, wait = [], 0, 0.0
    with reader, torch.inference_mode():
        batches = iter(loader)
        start = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            if steps >= WARMUP_STEPS:
                wait += time.perf_counter() - t0
            if batch is None:
                break
            if batch["image"].device.type != "cuda":
                raise AssertionError(f"the adapter delivered {batch['image'].device}")
            logits = model(normalize.normalize_images(batch["image"], MEAN, STD))
            if not bool(torch.isfinite(logits).all()) or logits.shape != (BATCH, 1000):
                raise AssertionError(f"adapter step {steps}: bad logits {tuple(logits.shape)}")
            delivered.append(batch["label"])
            steps += 1
            if steps == WARMUP_STEPS:
                torch.cuda.synchronize()
                timed_start = time.perf_counter()
        torch.cuda.synchronize()
        end = time.perf_counter()
    launches = normalize.normalize_kernel.launches
    decoded = check_native_decode(reader.decode_stats(), N_ROWS, "the torch adapter")
    if steps != N_ROWS // BATCH or launches != steps:
        raise AssertionError(f"the adapter gave {steps} batches and {launches} normalize"
                             f" launches, expected {N_ROWS // BATCH} of each")
    reader, cpu_loader = adapter_loader(path, "cpu")
    with reader:
        cpu_labels = torch.cat([b["label"] for b in cpu_loader])
    if not torch.equal(torch.cat(delivered).cpu(), cpu_labels):
        raise AssertionError("the adapter on the card delivered other labels than on the CPU")
    timed = end - timed_start
    phase("torch_adapter", shuffling_queue_capacity=SHUFFLE_CAPACITY, seed=0, batches=steps,
          timed_steps=steps - WARMUP_STEPS, batch=BATCH,
          samples_per_s=(steps - WARMUP_STEPS) * BATCH / timed,
          cuda_data_loader_samples_per_s=main_samples_per_s, epoch_s=end - start,
          consumer_wait_share=wait / timed,
          peak_device_memory_bytes=torch.cuda.max_memory_allocated(),
          launches={"normalize_u8": launches}, decode_stats=decoded, labels_match_cpu_run=True)


def read_rate(path, workers, **kwargs):
    """The reader alone over RATE_EPOCHS epochs of the dataset (no loader, no
    model): rows/s, its decode counters, and the first rowgroup it gave."""
    reader = make_reader(path, workers_count=workers, shuffle_seed=0, num_epochs=RATE_EPOCHS,
                         **kwargs)
    rows, rowgroups, first = 0, 0, None
    with reader:
        start = time.perf_counter()
        for batch in reader.iter_batches():
            rows += batch.num_rows
            rowgroups += 1
            first = batch if first is None else first
        seconds = time.perf_counter() - start
    if rows != RATE_EPOCHS * N_ROWS:
        raise AssertionError(f"the reader gave {rows} rows over {RATE_EPOCHS} epochs")
    return ({"rows_per_s": rows / seconds, "rows": rows, "rowgroups": rowgroups,
             "seconds": seconds}, reader.decode_stats(), first, reader.plan.epoch_items(0)[0])


def one_thread_decode(path):
    """One thread over one 256-cell column: the plain per-cell cv2 decode
    (the codec's per-cell path) against ``decode_column_native``, in turns;
    returns (ms each, median of 5, and the two results of the last turn)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from petastorm_tpu_torch.etl.metadata import infer_or_load_schema, open_dataset

    field = infer_or_load_schema(open_dataset(path))["image"]
    pf = pq.ParquetFile(pa.memory_map(open_dataset(path).row_groups[0].path))
    column = pf.read_row_group(0, columns=["image"]).column("image").combine_chunks()
    times = {"per_cell_cv2": [], "native": []}
    for _ in range(5):
        t0 = time.perf_counter()
        plain = codecs.Codec.decode_column(field.codec, field, column)
        t1 = time.perf_counter()
        out = np.empty((len(column),) + field.shape, np.uint8)
        if not native_image.decode_column_native(column, out, nthreads=1):
            raise AssertionError("decode_column_native did not take the column")
        t2 = time.perf_counter()
        times["per_cell_cv2"].append(1e3 * (t1 - t0))
        times["native"].append(1e3 * (t2 - t1))
    return {k: float(np.median(v)) for k, v in times.items()}, plain, out, len(column)


def native_vs_cv2(path):
    """The native decode against the per-cell cv2 decode on every image of
    the dataset (each rowgroup's column in one native call): the number of
    bytes that differ and the largest difference; raises unless 0."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from petastorm_tpu_torch.etl.metadata import infer_or_load_schema, open_dataset

    info = open_dataset(path)
    field = infer_or_load_schema(info)["image"]
    differing, largest, images = 0, 0, 0
    for rg in info.row_groups:
        pf = pq.ParquetFile(pa.memory_map(rg.path))
        column = pf.read_row_group(rg.row_group, columns=["image"]).column("image")
        column = column.combine_chunks()
        out = np.empty((len(column),) + field.shape, np.uint8)
        native_image.decode_column_native(column, out)
        diff = np.abs(out.astype(np.int16) - codecs.Codec.decode_column(
            field.codec, field, column).astype(np.int16))
        differing, largest = differing + int((diff > 0).sum()), max(largest, int(diff.max()))
        images += len(column)
    if differing:
        raise AssertionError(f"the native decode differs from cv2's on {differing} bytes of"
                             f" {images} images, by up to {largest}")
    return {"images": images, "bytes_differing": differing, "max_diff": largest}


def reader_rate_phase(path):
    """The reader alone over RATE_EPOCHS epochs (64 rowgroups) of the dataset:
    rows/s of the native host decode at ``decode_threads='auto'``, of the
    same with ``decode_roi``, and of the entropy decode only with the same
    fan-out, same workers; the one-thread decode of one column, native
    against per-cell cv2; the native bytes against cv2's on every image;
    the reader's ROI crops against slices of the full decode at the
    offsets of a CPU run of the worker's ``_roi_for``."""
    cores = os.cpu_count() or 2
    workers = max(1, min(cores - 1, 16))
    decode_threads = max(1, len(os.sched_getaffinity(0)) // workers)  # the reader's 'auto'
    rates, stats = {}, {}
    rates["native"], stats["native"], _, _ = read_rate(path, workers)
    check_native_decode(stats["native"], RATE_EPOCHS * N_ROWS, "phase 7, native")
    rates["native_roi"], stats["native_roi"], roi_batch, roi_item = read_rate(
        path, workers, decode_roi={"image": ROI})
    check_native_decode(stats["native_roi"], RATE_EPOCHS * N_ROWS, "phase 7, ROI", "roi")
    rates["entropy_only"], stats["entropy_only"], _, _ = read_rate(
        path, workers, decode_placement={"image": "device"})
    check_native_decode(stats["entropy_only"], RATE_EPOCHS * N_ROWS, "phase 7, entropy",
                        "coef_batch")

    one_thread_ms, plain, native, cells = one_thread_decode(path)
    if not np.array_equal(plain, native):
        raise AssertionError("one thread: the native decode differs from per-cell cv2")
    vs_cv2 = native_vs_cv2(path)

    # the ROI read's first rowgroup: its crops are slices of the full native
    # decode of that rowgroup at the offsets _roi_for gives on the CPU
    full_reader = make_reader(path, workers_count=1, shuffle_seed=0, num_epochs=1)
    with full_reader:
        full = next(full_reader.iter_batches())
    if full_reader.plan.epoch_items(0)[0] != roi_item:
        raise AssertionError("the full read began with another rowgroup than the ROI read")
    worker = RowGroupDecoderWorker(full_reader.schema, ["image"], decode_roi={"image": ROI})
    ys, xs, crop_h, crop_w = worker._roi_for("image", roi_item, roi_item.num_rows)
    for i in range(roi_item.num_rows):
        want = full.columns["image"][i, ys[i]:ys[i] + crop_h, xs[i]:xs[i] + crop_w]
        if not np.array_equal(roi_batch.columns["image"][i], want):
            raise AssertionError(f"ROI row {i}: not the slice of the full decode at _roi_for's"
                                 f" offset ({ys[i]}, {xs[i]})")
    phase("reader_decode_rate", cpu_count=cores, workers=workers,
          decode_threads=decode_threads, epochs=RATE_EPOCHS,
          in_flight_window_rowgroups=workers + 10, host_native=rates["native"],
          host_native_roi={"decode_roi": list(ROI), **rates["native_roi"]},
          device_entropy_only=rates["entropy_only"], decode_stats=stats,
          one_thread_column={"cells": cells, "ms": one_thread_ms,
                             "native_speedup": one_thread_ms["per_cell_cv2"]
                             / one_thread_ms["native"], "equal": True},
          native_vs_cv2=vs_cv2,
          roi_vs_sliced_full_decode={"rowgroup": roi_item.row_group.global_index,
                                     "rows": roi_item.num_rows, "equal": True,
                                     "offsets_from": "RowGroupDecoderWorker._roi_for"})
    return rates


def drained_inference_phase(path, main_samples_per_s):
    """Phase 4's inference path (host decode) over RATE_EPOCHS epochs: 64
    batches, about 4x the reader's in-flight window, so the later batches
    wait on the decode itself.  Samples/s and input-wait share over all
    timed batches and over those from DRAINED_FROM on."""
    cores = os.cpu_count() or 2
    workers = max(1, min(cores - 1, 16))
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16, device="cuda",
                     generator=torch.Generator().manual_seed(0))
    model = model.to(memory_format=torch.channels_last)
    reader = make_reader(path, workers_count=workers, shuffle_seed=0, num_epochs=RATE_EPOCHS,
                         decode_placement={"image": "host"})
    torch.cuda.synchronize()
    normalize.normalize_kernel.launches = 0
    delivered, steps, marks = [], 0, {}
    with CudaDataLoader(reader, batch_size=BATCH, device="cuda") as loader, \
            torch.inference_mode():
        for batch in loader:
            logits = model(normalize.normalize_images(batch["image"], MEAN, STD))
            delivered.append(batch["label"])
            if not bool(torch.isfinite(logits).all()) or logits.shape != (BATCH, 1000):
                raise AssertionError(f"batch {steps}: bad logits {tuple(logits.shape)}")
            steps += 1
            if steps in (WARMUP_STEPS, DRAINED_FROM):
                torch.cuda.synchronize()
                marks[steps] = (time.perf_counter(), loader.diagnostics()["consumer_wait_s"])
        torch.cuda.synchronize()
        end = (time.perf_counter(), loader.diagnostics()["consumer_wait_s"])
    launches = normalize.normalize_kernel.launches
    want_steps = RATE_EPOCHS * N_ROWS // BATCH
    if steps != want_steps or launches != steps:
        raise AssertionError(f"{steps} batches and {launches} normalize launches, expected"
                             f" {want_steps} of each")
    counts = np.bincount(torch.cat(delivered).cpu().numpy(), minlength=N_ROWS)
    if not (counts == RATE_EPOCHS).all():
        raise AssertionError(f"labels over {RATE_EPOCHS} epochs are not each label"
                             f" {RATE_EPOCHS} times")
    decoded = check_native_decode(reader.decode_stats(), RATE_EPOCHS * N_ROWS, "phase 10")

    def rates(first_batch):
        (t0, w0), (t1, w1) = marks[first_batch], end
        return {"batches": steps - first_batch, "seconds": t1 - t0,
                "samples_per_s": (steps - first_batch) * BATCH / (t1 - t0),
                "consumer_wait_share": (w1 - w0) / (t1 - t0)}

    drained = {"all_timed": rates(WARMUP_STEPS), "after_window_drained": rates(DRAINED_FROM)}
    phase("inference_drained", epochs=RATE_EPOCHS, batches=steps, batch=BATCH,
          workers=workers, in_flight_window_rowgroups=workers + 10,
          drained_from_batch=DRAINED_FROM, **drained,
          phase4_samples_per_s=main_samples_per_s, launches={"normalize_u8": launches},
          decode_stats=decoded, labels_each_4_times=True)
    return drained


def kernel_counts_by_name(fn, names, margin_s=0.05):
    """``torch.profiler`` over one call of ``fn``: for each ``label: part`` of
    ``names`` the number of device kernels whose name holds ``part``, the
    number of device kernels seen, and the first kernel's start after the
    trace's (us).  ``margin_s`` of host idle time inside the trace on both
    sides keeps the call's kernels away from the window's edges."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(margin_s)
        fn()
        torch.cuda.synchronize()
        time.sleep(margin_s)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    counts = {label: sum(part in e.name for e in kernels) for label, part in names.items()}
    first_us = min((e.time_range.start for e in kernels), default=None)
    return counts, len(kernels), first_us


def replay_kernel_counts(fn, names, expected, observations=3):
    """``observations`` profiles of one call of ``fn`` each (see
    ``kernel_counts_by_name``).  The profiler can lose device records: on
    an H100 a replay of 7662 kernels was once recorded as 7558, one B1 and
    one B3 among the lost ones.  So the counts by name are held to
    ``expected`` exactly in every observation that saw the most device
    kernels, the fullest record, and no observation may count more than
    ``expected``.  Returns the observations."""
    seen = []
    for _ in range(observations):
        counts, total, first_us = kernel_counts_by_name(fn, names)
        seen.append({"kernels": counts, "device_kernels": total, "first_kernel_us": first_us})
    fullest = max(o["device_kernels"] for o in seen)
    for o in seen:
        over = any(o["kernels"][name] > k for name, k in expected.items())
        if over or (o["device_kernels"] == fullest and o["kernels"] != expected):
            raise AssertionError(f"profiled replays ran {seen} (the fullest record has"
                                 f" {fullest} device kernels), expected {expected} of B1"
                                 " and B3 in each")
    return seen


def leaves_and_momentum(step):
    return [t.detach() for t in step.leaves + step.momentum()]


def graph_vs_eager(step, scan, images, labels):
    """One unit replayed from the graph against the same unit run as SCAN_K
    eager steps, twice, each from the same leaves, momentum and generator
    state.  The draws must be equal bit for bit; the losses and leaves of the
    graph within twice the spread of the two eager runs (cuDNN's backward is
    not bit-deterministic; a spread of 0 asks for equality).  Leaves the
    state as it found it.  Returns the comparison and the loss bound."""
    snapshot = [t.clone() for t in leaves_and_momentum(step)], step.generator.get_state()

    def restore():
        with torch.no_grad():
            for t, saved in zip(leaves_and_momentum(step), snapshot[0]):
                t.copy_(saved)
        step.generator.set_state(snapshot[1])

    restore()
    graph_losses = scan(images, labels).double()
    torch.cuda.synchronize()
    graph_draws = scan.last_draws
    graph_leaves = leaves_flat(step)
    eager = []
    for _ in range(2):
        restore()
        losses, boxes, flips = [], [], []
        for k in range(SCAN_K):
            losses.append(step(images[k], labels[k]))
            boxes.append(step.last_draws[0])
            flips.append(step.last_draws[1])
        eager.append((torch.stack(losses).double(), leaves_flat(step), torch.stack(boxes),
                      torch.stack(flips)))
    restore()
    if not (torch.equal(graph_draws[0], eager[0][2]) and torch.equal(graph_draws[1], eager[0][3])):
        raise AssertionError("the graph's crop boxes or flips differ from the eager loop's")
    spread = {"loss": (eager[0][0] - eager[1][0]).abs().max().item(),
              "leaf": (eager[0][1] - eager[1][1]).abs().max().item()}
    err = {"loss": (graph_losses - eager[0][0]).abs().max().item(),
           "leaf": (graph_leaves - eager[0][1]).abs().max().item()}
    bound = {name: 2 * v for name, v in spread.items()}
    if not all(err[name] <= bound[name] for name in err):
        raise AssertionError(f"the graph's unit differs from the eager loop's by {err}, beyond"
                             f" twice the eager runs' own spread {spread}")
    return {"draws_equal": True, "max_abs_err": err, "eager_spread": spread, "bound": bound,
            "graph_losses": graph_losses.tolist(), "eager_losses": eager[0][0].tolist()}, \
        bound["loss"]


def scan_train_phase(path, device):
    """Phase 6's training path (device decode) with ``stack_batches=SCAN_K``
    and the trainer's ``ScanStep``: the first unit runs eagerly and the graph
    is captured, the next 3 units are timed replays.  Every kernel count set
    to 0 just before the path and read just after it: B2 once a unit (as many
    launches as units the loader staged, prefetched ones included, since
    ``num_epochs=None``), B1 and B3 SCAN_K times in the warm-up unit and
    SCAN_K times in the capture, none counted by a replay, and SCAN_K each
    in profiled replays (``replay_kernel_counts``)."""
    cores = os.cpu_count() or 2
    workers = max(1, min(cores - 1, 16))
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16, device="cuda",
                     generator=torch.Generator().manual_seed(0))
    model = model.to(memory_format=torch.channels_last)
    step = trainer.TrainStep(model, 1000, SIDE, generator=torch.Generator(device="cuda")
                             .manual_seed(trainer.AUGMENT_SEED))
    scan = trainer.ScanStep(step, SCAN_K)
    reader = make_reader(path, workers_count=workers, shuffle_seed=0, num_epochs=None,
                         decode_placement={"image": "device"})
    units = N_ROWS // BATCH // SCAN_K
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, labels_seen = [], []
    with CudaDataLoader(reader, batch_size=BATCH, device="cuda",
                        stack_batches=SCAN_K) as loader:
        it = iter(loader)
        start = time.perf_counter()
        unit = next(it)
        if unit["image"].shape != (SCAN_K, BATCH, SIDE, SIDE, 3) or VALID_ROWS in unit:
            raise AssertionError(f"stacked unit {tuple(unit['image'].shape)}, keys {list(unit)}")
        labels_seen.append(unit["label"])
        losses.append(scan(unit["image"], unit["label"] % 1000))  # warm-up and capture
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - start
        captured = {"normalize_u8": normalize.normalize_kernel.launches,
                    "resized_crop_flip_u8": augment.resized_crop_kernel.launches_tiled}
        timed_start, wait0 = time.perf_counter(), loader.diagnostics()["consumer_wait_s"]
        for _ in range(units - 1):
            unit = next(it)
            labels_seen.append(unit["label"])
            losses.append(scan(unit["image"], unit["label"] % 1000))
        torch.cuda.synchronize()
        end = time.perf_counter()
        wait = loader.diagnostics()["consumer_wait_s"] - wait0
        peak = torch.cuda.max_memory_allocated()
        after = {"normalize_u8": normalize.normalize_kernel.launches,
                 "resized_crop_flip_u8": augment.resized_crop_kernel.launches_tiled}
        replays = scan.replays
        images, labels = unit["image"], unit["label"] % 1000
        profiled = replay_kernel_counts(
            lambda: scan(images, labels),
            {"normalize_u8": "normalize_u8_kernel",
             "resized_crop_flip_u8": "resized_crop_tiled_kernel"},
            {"normalize_u8": SCAN_K, "resized_crop_flip_u8": SCAN_K})
        vs_eager, loss_bound = graph_vs_eager(step, scan, images, labels)
    diagnostics = loader.diagnostics()
    b2 = {"tiled": jpeg.jpeg_decode_kernel.launches_tiled,
          "general": jpeg.jpeg_decode_kernel.launches_general,
          "units_staged": diagnostics["units_staged"]}
    # the reader decodes ahead of the loader (num_epochs=None): every image
    # through the entropy call, at least those of the staged units
    decoded = reader.decode_stats()
    others = {k: v for k, v in decoded.items() if not k.startswith("coef_batch")}
    if any(others.values()) or decoded["coef_batch_images"] < b2["units_staged"] * SCAN_K * BATCH:
        raise AssertionError(f"phase 11: native decode counters {decoded}")

    labels_seen = torch.cat([lab.reshape(-1) for lab in labels_seen]).cpu()
    if not torch.equal(labels_seen, device["labels"]):
        raise AssertionError("the stacked epoch delivered other labels, or in another order,"
                             " than phase 6")
    if b2["tiled"] != b2["units_staged"] or b2["general"] or b2["units_staged"] < units:
        raise AssertionError(f"B2 launches {b2} for {units} units consumed: expected one tiled"
                             " launch a staged unit")
    per_replay = {"normalize_u8": SCAN_K, "resized_crop_flip_u8": SCAN_K}
    for name, k in per_replay.items():
        if captured[name] != 2 * k or after[name] != captured[name]:
            raise AssertionError(f"{name}: {captured[name]} launches counted by the warm-up and"
                                 f" the capture, {after[name]} after {replays} replays;"
                                 f" expected {2 * k} and no more")
    if augment.resized_crop_kernel.launches_aa or augment.resized_crop_kernel.launches_general:
        raise AssertionError("phase 11 launched another resized-crop kernel than the tiled one")
    losses = torch.cat(losses).float().cpu()
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"non-finite training loss: {losses.tolist()}")
    timed = end - timed_start
    samples_per_s = (units - 1) * SCAN_K * BATCH / timed
    phase("scan_train_device_decode", decode="device", scan_steps=SCAN_K,
          stack_batches=SCAN_K, units=units, timed_units=units - 1, batch=BATCH,
          workers=workers, samples_per_s=samples_per_s,
          phase6_samples_per_s=device["samples_per_s"],
          vs_phase6=samples_per_s / device["samples_per_s"],
          step_ms=1e3 * timed / ((units - 1) * SCAN_K), consumer_wait_share=wait / timed,
          warmup_and_capture_s=capture_s, peak_device_memory_bytes=peak,
          launches={"jpeg_decode_u8": b2["tiled"], "units_staged": b2["units_staged"],
                    "jpeg_decode_images_per_launch": SCAN_K * BATCH,
                    "normalize_u8": SCAN_K * (1 + replays),
                    "resized_crop_flip_u8": SCAN_K * (1 + replays)},
          counted_at_warmup_and_capture=captured, graph_replays=replays,
          profiled_replays=profiled,
          losses=losses.tolist(), labels_match_phase6_order=True, decode_stats=decoded,
          graph_vs_eager=vs_eager)
    return {"loss_bound": loss_bound, "samples_per_s": samples_per_s}


def checkpoint_resume_phase(path, host, loss_bound):
    """The host-decode training path for one epoch, cut by a drain and a
    checkpoint after CHECKPOINT_AFTER steps and resumed in a fresh model,
    optimizer, reader and loader; held to phase 5's uninterrupted epoch
    (same seeds, same rowgroup order): labels, digest, and the first resumed
    step's loss within phase 11's bound."""
    def fresh_step():
        model = ResNet50(num_classes=1000, dtype=torch.bfloat16, device="cuda",
                         generator=torch.Generator().manual_seed(0))
        model = model.to(memory_format=torch.channels_last)
        return trainer.TrainStep(model, 1000, SIDE, generator=torch.Generator(device="cuda")
                                 .manual_seed(trainer.AUGMENT_SEED))

    def reader(**kwargs):
        # 2 workers and 1 result slot: the reader's and the loader's windows
        # (3 + 4 rowgroups) leave part of the 16-rowgroup epoch to the resume
        return make_reader(path, workers_count=2, results_queue_size=1, shuffle_seed=0,
                           num_epochs=1, decode_placement={"image": "host"}, **kwargs)

    def train(step, batch):
        if VALID_ROWS in batch:
            raise AssertionError(f"a padded batch of {batch[VALID_ROWS]} rows")
        labels.append(batch["label"])
        losses.append(float(step(batch["image"], batch["label"] % 1000)))

    labels, losses = [], []
    step = fresh_step()
    with CudaDataLoader(reader(), batch_size=BATCH, device="cuda", drop_last=False,
                        prefetch=1) as loader:
        it = iter(loader)
        for _ in range(CHECKPOINT_AFTER):
            train(step, next(it))
        drained = 0
        for batch in loader.drain():
            train(step, batch)
            drained += 1
        loader_state = loader.state_dict()
    torch.cuda.synchronize()
    saved = [t.clone() for t in leaves_and_momentum(step)]
    steps_before = len(losses)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as directory:
        manager = make_checkpoint_manager(directory, max_to_keep=2)
        t0 = time.perf_counter()
        save_checkpoint(manager, steps_before, step.state_dict(), loader_state)
        save_s = time.perf_counter() - t0
        state_bytes = sum(os.path.getsize(os.path.join(manager.step_dir(steps_before), f))
                          for f in os.listdir(manager.step_dir(steps_before)))
        del step
        resumed = fresh_step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_state, restored_loader = restore_checkpoint(manager,
                                                          template=resumed.state_dict())
        resumed.load_state_dict(train_state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    restored = leaves_and_momentum(resumed)
    if len(restored) != len(saved) or not all(torch.equal(a, b)
                                              for a, b in zip(restored, saved)):
        raise AssertionError("the restored leaves or momentum differ from the saved ones")
    resumed_reader = reader(**resume_reader_kwargs(restored_loader))
    with CudaDataLoader(resumed_reader, batch_size=BATCH, device="cuda", drop_last=False,
                        prefetch=1) as loader:
        for batch in loader:
            train(resumed, batch)
    digest = resumed_reader.stream_digest

    if len(losses) == steps_before:
        raise AssertionError("the drain consumed the whole epoch: nothing was left to resume")
    if not torch.equal(torch.cat(labels).cpu(), host["labels"]):
        raise AssertionError("the drained and resumed halves delivered other labels, or in"
                             " another order, than one uninterrupted epoch")
    if digest["combined"] != host["digest"]["combined"]:
        raise AssertionError(f"resumed digest {digest} differs from an uninterrupted reader's"
                             f" {host['digest']}")
    first_err = abs(losses[steps_before] - float(host["losses"][steps_before]))
    if not first_err <= loss_bound:
        raise AssertionError(f"first resumed step's loss {losses[steps_before]} differs from the"
                             f" uninterrupted run's {float(host['losses'][steps_before])} by"
                             f" {first_err} (bound {loss_bound})")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    phase("drain_checkpoint_resume", decode="host", steps_before_drain=CHECKPOINT_AFTER,
          drained_batches=drained, steps_before_checkpoint=steps_before,
          resumed_steps=len(losses) - steps_before, reader_position=loader_state["reader"],
          delivered_batches=loader_state["delivered_batches"], checkpoint_bytes=state_bytes,
          save_s=save_s, restore_s=restore_s, restored_bit_equal=True,
          labels_match_uninterrupted=True, digest=digest["combined"],
          digest_matches_uninterrupted=True,
          first_resumed_loss={"resumed": losses[steps_before],
                              "uninterrupted": float(host["losses"][steps_before]),
                              "abs_err": first_err, "bound": loss_bound},
          losses=losses)


def inference_epoch(path, model, loader_kwargs=None):
    """Phase 4's inference path (host decode, B1, the forward) for one epoch
    with the loader taking ``loader_kwargs``; B1's count set to 0 just
    before and read just after.  Returns the labels in delivery order, the
    rates and the loader's stage seconds a batch."""
    cores = os.cpu_count() or 2
    workers = max(1, min(cores - 1, 16))
    reader = make_reader(path, workers_count=workers, shuffle_seed=0, num_epochs=1,
                         decode_placement={"image": "host"})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    normalize.normalize_kernel.launches = 0
    delivered, steps = [], 0
    with CudaDataLoader(reader, batch_size=BATCH, device="cuda",
                        **(loader_kwargs or {})) as loader, torch.inference_mode():
        for batch in loader:
            logits = model(normalize.normalize_images(batch["image"], MEAN, STD))
            delivered.append(batch["label"])
            if not bool(torch.isfinite(logits).all()) or logits.shape != (BATCH, 1000):
                raise AssertionError(f"batch {steps}: bad logits {tuple(logits.shape)}")
            steps += 1
            if steps == WARMUP_STEPS:
                torch.cuda.synchronize()
                timed_start, wait0 = time.perf_counter(), loader.diagnostics()["consumer_wait_s"]
        torch.cuda.synchronize()
        end = time.perf_counter()
        diag = loader.diagnostics()
    launches = normalize.normalize_kernel.launches
    if steps != N_ROWS // BATCH or launches != steps:
        raise AssertionError(f"{steps} batches and {launches} normalize launches, expected"
                             f" {N_ROWS // BATCH} of each ({loader_kwargs})")
    decoded = check_native_decode(reader.decode_stats(), N_ROWS, f"phase 13 {loader_kwargs}")
    timed = end - timed_start
    return {"labels": torch.cat(delivered).cpu(),
            "samples_per_s": (steps - WARMUP_STEPS) * BATCH / timed,
            "consumer_wait_share": (diag["consumer_wait_s"] - wait0) / timed,
            "assemble_ms_per_batch": 1e3 * diag["assemble_s"] / steps,
            "transfer_ms_per_batch": 1e3 * diag["transfer_s"] / steps,
            "peak_device_memory_bytes": torch.cuda.max_memory_allocated(),
            "launches": {"normalize_u8": launches}, "decode_stats": decoded}


def shuffled_inference_phase(path, main_samples_per_s):
    """Phase 4's inference path three ways in one call: unshuffled, through
    the host shuffle buffer (SHUFFLE_CAPACITY rows, ``buffer_seed=0``) and
    through the device shuffle buffer (DEVICE_SHUFFLE_CAPACITY batches,
    ``device_shuffle_seed=0``), the last twice.  Each shuffled epoch's labels
    are the unshuffled epoch's as a multiset, in another order; the two
    device-buffer runs give one order.  The device buffer's exchange is
    timed a push with CUDA events on the copy stream it runs on; a push
    alone at the main shapes must synchronize nothing with the host."""
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16, device="cuda",
                     generator=torch.Generator().manual_seed(0))
    model = model.to(memory_format=torch.channels_last)
    device_kwargs = {"device_shuffle_capacity": DEVICE_SHUFFLE_CAPACITY,
                     "device_shuffle_seed": 0}
    runs = {"unshuffled": inference_epoch(path, model),
            "host_buffer": inference_epoch(path, model, {
                "shuffling_queue_capacity": SHUFFLE_CAPACITY, "buffer_seed": 0})}
    exchange = {"events": [], "host_s": []}
    real_exchange = device_buffer._exchange

    def timed_exchange(store, batch, slot, perm):
        # called on the loader's transfer thread inside its copy stream
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = real_exchange(store, batch, slot, perm)
        end.record()
        exchange["host_s"].append(time.perf_counter() - t0)
        exchange["events"].append((start, end))
        return out

    device_buffer._exchange = timed_exchange
    try:
        runs["device_buffer"] = inference_epoch(path, model, device_kwargs)
    finally:
        device_buffer._exchange = real_exchange
    torch.cuda.synchronize()
    exchange_ms = [start.elapsed_time(end) for start, end in exchange["events"]]
    again = inference_epoch(path, model, device_kwargs)

    plain = runs["unshuffled"]["labels"].numpy()
    for name in ("host_buffer", "device_buffer"):
        labels = runs[name]["labels"].numpy()
        if not np.array_equal(np.sort(labels), np.sort(plain)):
            raise AssertionError(f"phase 13, {name}: other labels than the unshuffled epoch")
        if np.array_equal(labels, plain):
            raise AssertionError(f"phase 13, {name}: the unshuffled epoch's order")
    if not torch.equal(again["labels"], runs["device_buffer"]["labels"]):
        raise AssertionError("phase 13: two device-buffer runs with one seed gave two orders")
    pushes = N_ROWS // BATCH - DEVICE_SHUFFLE_CAPACITY
    if len(exchange_ms) != pushes:
        raise AssertionError(f"phase 13: {len(exchange_ms)} exchanges, expected {pushes}")

    # a push at the main shapes, alone: no host sync (the slot is drawn on
    # the host, the permutation on the card)
    buf = device_buffer.DeviceShufflingBuffer(DEVICE_SHUFFLE_CAPACITY, seed=0, device="cuda")
    batch = {"image": torch.zeros(MAIN_SHAPE, dtype=torch.uint8, device="cuda"),
             "label": torch.arange(BATCH, device="cuda")}
    for _ in range(DEVICE_SHUFFLE_CAPACITY):
        buf.push(batch)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(4):
            buf.push(batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    # a push on an idle card (the in-run exchanges share it with the forward)
    # against the least time of its bytes: the slot and the batch read once,
    # the emitted batch and the new slot written once
    alone_ms = time_ms(lambda: buf.push(batch))
    slot_bytes = BATCH * SIDE * SIDE * 3 + BATCH * 8
    exchange_bound_ms = 1e3 * 4 * slot_bytes / HBM_BYTES_PER_S
    del buf, batch

    phase("inference_shuffled", batch=BATCH, steps=N_ROWS // BATCH,
          timed_steps=N_ROWS // BATCH - WARMUP_STEPS,
          shuffling_queue_capacity=SHUFFLE_CAPACITY,
          device_shuffle_capacity=DEVICE_SHUFFLE_CAPACITY,
          device_store_bytes=DEVICE_SHUFFLE_CAPACITY * slot_bytes,
          phase4_samples_per_s=main_samples_per_s,
          runs={name: {k: v for k, v in run.items() if k != "labels"}
                for name, run in runs.items()},
          device_buffer_rerun_samples_per_s=again["samples_per_s"],
          exchange={"pushes": pushes, "device_ms_median": float(np.median(exchange_ms)),
                    "device_ms_mean": float(np.mean(exchange_ms)),
                    "device_ms_max": float(np.max(exchange_ms)),
                    "host_ms_median": 1e3 * float(np.median(exchange["host_s"])),
                    "alone_ms": alone_ms, "bytes_bound_ms": exchange_bound_ms},
          labels_multisets_equal=True, orders_differ_from_unshuffled=True,
          device_buffer_same_seed_same_order=True, push_without_host_sync=True)


def cached_read_rate(path, workers, cache_type, **kwargs):
    """The reader alone over RATE_EPOCHS epochs with ``cache_type``, entropy
    decode only: rows/s of the cold first epoch (the pool's start-up
    included) and of the warm rest, and the cache's and decode's counters;
    ``'null'`` is the same reader with every epoch cold."""
    reader = make_reader(path, workers_count=workers, shuffle_seed=0, num_epochs=RATE_EPOCHS,
                         decode_placement={"image": "device"}, cache_type=cache_type, **kwargs)
    rows, marks = 0, []
    with reader:
        start = time.perf_counter()
        for batch in reader.iter_batches():
            rows += batch.num_rows
            if rows % N_ROWS == 0:
                marks.append(time.perf_counter())
        stats, decoded = reader.cache_stats(), reader.decode_stats()
    if rows != RATE_EPOCHS * N_ROWS or len(marks) != RATE_EPOCHS:
        raise AssertionError(f"the cached reader gave {rows} rows over {RATE_EPOCHS} epochs")
    groups = N_ROWS // ROWS_PER_GROUP
    want = (0, 0) if cache_type == "null" else (groups, groups * (RATE_EPOCHS - 1))
    if (stats["misses"], stats["hits"]) != want:
        raise AssertionError(f"{cache_type} cache: {stats}, expected {want[0]} misses and"
                             f" {want[1]} hits")
    check_native_decode(decoded, N_ROWS * (RATE_EPOCHS if cache_type == "null" else 1),
                        f"phase 14, {cache_type} reader", "coef_batch")
    return {"cold_rows_per_s": N_ROWS / (marks[0] - start),
            "warm_rows_per_s": (RATE_EPOCHS - 1) * N_ROWS / (marks[-1] - marks[0]),
            "cache_stats": stats}


def warm_cache_train_phase(path):
    """Phase 6's training path (device decode: B2, B3, B1, the step) for
    CACHE_EPOCHS epochs with ``cache_type='memory'``, against the same run
    with ``'null'``: one miss a rowgroup and a hit a rowgroup a later epoch,
    the entropy decode in the first epoch only, the labels and every batch's
    image sum (after B2) equal, the first batch's images bit for bit.  Then
    the reader alone, cold epoch against warm, in memory and on local disk."""
    groups = N_ROWS // ROWS_PER_GROUP
    runs = {cache: train_epoch(path, "device", epochs=CACHE_EPOCHS,
                               reader_kwargs={"cache_type": cache})
            for cache in ("null", "memory")}
    null, warm = runs["null"], runs["memory"]
    stats = warm["cache_stats"]
    if (stats["misses"], stats["hits"]) != (groups, groups * (CACHE_EPOCHS - 1)):
        raise AssertionError(f"phase 14: cache {stats}, expected {groups} misses and"
                             f" {groups * (CACHE_EPOCHS - 1)} hits")
    if not torch.equal(warm["labels"], null["labels"]):
        raise AssertionError("phase 14: the cached run delivered other labels or order")
    if not torch.equal(warm["image_sums"], null["image_sums"]):
        raise AssertionError("phase 14: the cached run's images differ from the uncached run's")
    if not torch.equal(warm["first"][0], null["first"][0]):
        raise AssertionError("phase 14: the first batch's images after B2 differ")
    if warm["digest"] != null["digest"]:
        raise AssertionError("phase 14: the cached run's stream digest differs")
    for run in runs.values():
        if run["launches"]["jpeg_decode_u8"] != run["steps"]:
            raise AssertionError(f"phase 14: B2 launched {run['launches']} in {run['steps']}"
                                 " steps")

    def per_epoch(run):
        marks = [run["timed_start"]] + run["epoch_marks"]
        out = []
        for k, ((t0, w0), (t1, w1)) in enumerate(zip(marks, marks[1:])):
            steps = N_ROWS // BATCH - (WARMUP_STEPS if k == 0 else 0)
            out.append({"epoch": k + 1, "steps": steps, "samples_per_s": steps * BATCH / (t1 - t0),
                        "consumer_wait_share": (w1 - w0) / (t1 - t0)})
        return out

    cores = os.cpu_count() or 2
    workers = max(1, min(cores - 1, 16))
    reader_alone = {cache: cached_read_rate(path, workers, cache)
                    for cache in ("null", "memory")}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cache_") as cache_dir:
        reader_alone["local-disk"] = cached_read_rate(path, workers, "local-disk",
                                                      cache_location=cache_dir)
        disk_bytes = sum(os.path.getsize(os.path.join(cache_dir, f))
                         for f in os.listdir(cache_dir))
    reader_alone["local-disk"]["directory_bytes"] = disk_bytes
    phase("warm_cache_train_device_decode", decode="device", epochs=CACHE_EPOCHS,
          rowgroups=groups, batch=BATCH, workers=null["workers"],
          cache_stats=stats, cache_resident_bytes=stats["bytes"],
          decode_stats={"null": null["decode_stats"], "memory": warm["decode_stats"]},
          per_epoch={"null": per_epoch(null), "memory": per_epoch(warm)},
          samples_per_s={"null": null["samples_per_s"], "memory": warm["samples_per_s"]},
          peak_device_memory_bytes={"null": null["peak"], "memory": warm["peak"]},
          launches={"null": null["launches"], "memory": warm["launches"]},
          assemble_ms_per_batch={k: 1e3 * r["diagnostics"]["assemble_s"] / r["steps"]
                                 for k, r in runs.items()},
          reader_alone_entropy_only=reader_alone, labels_equal=True, image_sums_equal=True,
          first_batch_bit_equal=True, digest_equal=True)
    return {"samples_per_s": warm["samples_per_s"], "per_epoch": per_epoch(warm)}


FILTER_DROPPED_GROUPS = (2, 5, 9, 13)  # phase 15: rowgroups the selector leaves out
FILTER_SPLIT = ([0.75, 0.25], 0)       # phase 15: the pseudorandom split kept


def label_to_target(cols):
    """Phase 16's transform: ``target`` = ``label`` mod 1000, ``image`` kept."""
    return {"image": cols["image"], "target": cols["label"] % 1000}


def target_spec():
    return TransformSpec(label_to_target, edit_fields=[("target", np.int64, (), False)],
                         removed_fields=["label"])


def rowgroup_labels(path):
    """The written labels of each rowgroup, by global index."""
    info = open_dataset(path)
    return [pq.ParquetFile(ref.path).read_row_group(ref.row_group, columns=["label"])
            .column("label").to_numpy() for ref in info.row_groups]


def filtered_reader_kwargs(labels_by_group, **extra):
    """Phase 15's selection: a selector over the rowgroup index keeping 12 of
    the 16 rowgroups, a pseudorandom split of the labels, 2 row-drop
    partitions; device decode."""
    kept = [int(v) for g, vs in enumerate(labels_by_group) if g not in FILTER_DROPPED_GROUPS
            for v in vs]
    return dict(decode_placement={"image": "device"}, shuffle_seed=0,
                rowgroup_selector=SingleIndexSelector("label_ix", kept),
                predicate=in_pseudorandom_split(*FILTER_SPLIT, "label"),
                shuffle_row_drop_partitions=2, **extra)


def cpu_reader_run(path, **kwargs):
    """The same reader with the serial pool on the host: its labels in
    delivery order, the epoch of each delivered rowgroup, and its digest."""
    labels, epochs = [], []
    with make_reader(path, reader_pool_type="serial", **kwargs) as reader:
        ipe = reader.state_dict()["items_per_epoch"]
        for batch in reader.iter_batches():
            labels.append(batch.columns["label"])
            epochs.append((reader.state_dict()["position"] - 1) // ipe)
        return labels, epochs, reader.stream_digest


def filtered_train_phase(path, kernels, device):
    """Phase 15: training with device decode over a rowgroup selector, a
    predicate and row-drop partitions for 2 epochs; then two shards in
    ``shard_mode='epoch'`` through the loader and inference."""
    cores = os.cpu_count() or 2
    workers = max(1, min(cores - 1, 16))
    indexed = path + "_indexed"
    shutil.copytree(path, indexed)
    t0 = time.perf_counter()
    build_rowgroup_index(indexed, [SingleFieldIndexer("label_ix", "label")])
    index_s = time.perf_counter() - t0
    by_group = rowgroup_labels(indexed)
    split = in_pseudorandom_split(*FILTER_SPLIT, "label")
    survivors = np.concatenate([vs[split.do_include_vectorized({"label": vs})]
                                for g, vs in enumerate(by_group)
                                if g not in FILTER_DROPPED_GROUPS])
    epochs = 2
    run = train_epoch(indexed, "device", epochs=epochs,
                      reader_kwargs={k: v for k, v in filtered_reader_kwargs(by_group).items()
                                     if k not in ("decode_placement", "shuffle_seed")},
                      rows=epochs * len(survivors), decoded_images=epochs * len(survivors))
    for name in ("normalize_u8", "resized_crop_flip_u8", "jpeg_decode_u8"):
        kernels[name]["launches"] += run["launches"][name]
    cpu_labels, _, cpu_digest = cpu_reader_run(indexed, num_epochs=epochs,
                                               **filtered_reader_kwargs(by_group))
    cpu_labels = np.concatenate(cpu_labels)
    if not np.array_equal(np.sort(cpu_labels), np.sort(np.tile(survivors, epochs))):
        raise AssertionError("phase 15: the filtered stream is not the host's filtered set"
                             f" ({len(cpu_labels)} rows against {epochs} x {len(survivors)})")
    if not np.array_equal(run["labels"].numpy(), cpu_labels[:run["steps"] * BATCH]):
        raise AssertionError("phase 15: the card delivered other labels, or in another order,"
                             " than the CPU run of the same reader")
    if run["digest"] != cpu_digest:
        raise AssertionError("phase 15: the stream digest differs from the CPU run's")

    # two shards in epoch mode, in turn: the loader, B2, B1 and the forward
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16, device="cuda",
                     generator=torch.Generator().manual_seed(0))
    model = model.to(memory_format=torch.channels_last)
    shards, launches = [], {"normalize_u8": 0, "jpeg_decode_u8": 0}
    for shard in range(2):
        kwargs = filtered_reader_kwargs(by_group, num_epochs=epochs, shard_mode="epoch",
                                        cur_shard=shard, shard_count=2)
        reader = make_reader(indexed, workers_count=workers, **kwargs)
        reset_launch_counts()
        delivered, batches = [], 0
        with CudaDataLoader(reader, batch_size=BATCH, device="cuda", drop_last=False) as loader, \
                torch.inference_mode():
            for batch in loader:
                n = int(batch.get(VALID_ROWS, BATCH))
                logits = model(normalize.normalize_images(batch["image"], MEAN, STD))
                if not bool(torch.isfinite(logits[:n]).all()):
                    raise AssertionError(f"phase 15, shard {shard}: non-finite logits")
                delivered.append(batch["label"][:n].cpu())
                batches += 1
        torch.cuda.synchronize()
        counts = {"normalize_u8": normalize.normalize_kernel.launches,
                  "jpeg_decode_u8": jpeg.jpeg_decode_kernel.launches_tiled}
        if counts != {"normalize_u8": batches, "jpeg_decode_u8": batches}:
            raise AssertionError(f"phase 15, shard {shard}: {counts} in {batches} batches")
        for name, count in counts.items():
            launches[name] += count
        labels, item_epochs, digest = cpu_reader_run(indexed, **kwargs)
        if not np.array_equal(torch.cat(delivered).numpy(), np.concatenate(labels)):
            raise AssertionError(f"phase 15, shard {shard}: other labels than its CPU run")
        if reader.stream_digest != digest:
            raise AssertionError(f"phase 15, shard {shard}: digest differs from its CPU run's")
        shards.append([set(np.concatenate([b for b, e in zip(labels, item_epochs) if e == k])
                           .tolist()) for k in range(epochs)])
    for name, count in launches.items():
        kernels[name]["launches"] += count
    want = set(survivors.tolist())
    for k in range(epochs):
        if shards[0][k] & shards[1][k]:
            raise AssertionError(f"phase 15: the shards overlap in epoch {k}")
        if shards[0][k] | shards[1][k] != want:
            raise AssertionError(f"phase 15: the shards' union in epoch {k} is not the set")
    if shards[0][0] == shards[0][1]:
        raise AssertionError("phase 15: epoch mode dealt shard 0 the same rows twice")

    steps, timed = run["steps"], run["timed"]
    phase("filtered_train_device_decode", decode="device", epochs=epochs,
          rowgroups_selected=len(by_group) - len(FILTER_DROPPED_GROUPS),
          predicate="in_pseudorandom_split([0.75, 0.25], 0, 'label')",
          shuffle_row_drop_partitions=2, rows_per_epoch=len(survivors), steps=steps,
          timed_steps=steps - WARMUP_STEPS, batch=BATCH, workers=run["workers"],
          samples_per_s=run["samples_per_s"], phase6_samples_per_s=device["samples_per_s"],
          epoch_s=run["epoch_s"], step_ms=1e3 * timed / (steps - WARMUP_STEPS),
          consumer_wait_share=run["wait"] / timed, peak_device_memory_bytes=run["peak"],
          launches=run["launches"], general_resized_crop_launches=run["general_launches"],
          losses=run["losses"].tolist(), decode_stats=run["decode_stats"],
          index_build_s=index_s, labels_match_cpu_order=True, multiset_matches_host_set=True,
          digest_matches_cpu=True, coef_images_equal_survivors=True,
          epoch_shards={"batches_launches": launches, "disjoint_each_epoch": True,
                        "union_is_filtered_set": True, "deal_differs_between_epochs": True,
                        "digests_match_cpu": True,
                        "rows": [[len(e) for e in per] for per in shards]})


def transformed_train_phase(path, kernels, host):
    """Phase 16: training with host decode through a TransformSpec
    (``target`` = ``label`` mod 1000) for 2 epochs with a memory cache: the
    first epoch fills the cache with the transform's output, the second
    decodes and transforms nothing; then one epoch of the torch adapter over
    the same reader into inference."""
    verdict = transform_cache_info(target_spec())
    if not verdict[1]:
        raise AssertionError(f"phase 16: the transform is not cacheable: {verdict}")
    epochs, groups = 2, N_ROWS // ROWS_PER_GROUP
    reader_kwargs = {"cache_type": "memory", "transform_spec": target_spec()}
    run = train_epoch(path, "host", epochs=epochs, reader_kwargs=reader_kwargs,
                      label_field="target")
    for name in ("normalize_u8", "resized_crop_flip_u8"):
        kernels[name]["launches"] += run["launches"][name]
    stats = run["cache_stats"]
    want_stats = {"hits": groups, "misses": groups, "transform_hits": groups,
                  "transform_misses": groups}
    if {k: stats[k] for k in want_stats} != want_stats:
        raise AssertionError(f"phase 16: cache {stats}, expected {want_stats}")
    with make_reader(path, reader_pool_type="serial", shuffle_seed=0, num_epochs=epochs,
                     decode_placement={"image": "host"}, **reader_kwargs) as reader:
        cpu_targets = np.concatenate([b.columns["target"] for b in reader.iter_batches()])
    if not np.array_equal(run["labels"].numpy(), cpu_targets[:run["steps"] * BATCH]):
        raise AssertionError("phase 16: the card trained on other targets, or in another"
                             " order, than the CPU run of the same reader")
    if not np.array_equal(cpu_targets[:N_ROWS], host["labels"].numpy() % 1000):
        raise AssertionError("phase 16: the targets are not phase 5's labels mod 1000")

    # the torch adapter over the same reader, one epoch, into inference
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16, device="cuda",
                     generator=torch.Generator().manual_seed(0))
    model = model.to(memory_format=torch.channels_last)

    def adapter(device):
        cores = os.cpu_count() or 2
        reader = make_reader(path, workers_count=max(1, min(cores - 1, 16)), shuffle_seed=0,
                             num_epochs=1, decode_placement={"image": "host"},
                             transform_spec=target_spec())
        return reader, torch_adapter.BatchedDataLoader(
            reader, batch_size=BATCH, shuffling_queue_capacity=SHUFFLE_CAPACITY, seed=0,
            transform_fn=lambda b: {k: v.to(device) for k, v in b.items()})

    reader, loader = adapter("cuda")
    normalize.normalize_kernel.launches = 0
    delivered = []
    with reader, torch.inference_mode():
        start = time.perf_counter()
        for batch in loader:
            logits = model(normalize.normalize_images(batch["image"], MEAN, STD))
            if not bool(torch.isfinite(logits).all()) or logits.shape != (BATCH, 1000):
                raise AssertionError(f"phase 16 adapter: bad logits {tuple(logits.shape)}")
            delivered.append(batch["target"])
        torch.cuda.synchronize()
        adapter_s = time.perf_counter() - start
    adapter_launches = normalize.normalize_kernel.launches
    if len(delivered) != N_ROWS // BATCH or adapter_launches != len(delivered):
        raise AssertionError(f"phase 16 adapter: {len(delivered)} batches, {adapter_launches}"
                             " normalize launches")
    kernels["normalize_u8"]["launches"] += adapter_launches
    reader, cpu_loader = adapter("cpu")
    with reader:
        cpu_adapter = torch.cat([b["target"] for b in cpu_loader])
    if not torch.equal(torch.cat(delivered).cpu(), cpu_adapter):
        raise AssertionError("phase 16 adapter: other targets than its CPU run")

    marks = [run["timed_start"]] + run["epoch_marks"]
    per_epoch = []
    for k, ((t0, w0), (t1, w1)) in enumerate(zip(marks, marks[1:])):
        steps = N_ROWS // BATCH - (WARMUP_STEPS if k == 0 else 0)
        per_epoch.append({"epoch": k + 1, "steps": steps,
                          "samples_per_s": steps * BATCH / (t1 - t0),
                          "consumer_wait_share": (w1 - w0) / (t1 - t0)})
    steps, timed = run["steps"], run["timed"]
    phase("transformed_train_host_decode", decode="host", epochs=epochs, steps=steps,
          timed_steps=steps - WARMUP_STEPS, batch=BATCH, workers=run["workers"],
          transform_cache_info={"signature": verdict[0], "cacheable": verdict[1],
                                "reason": verdict[2]},
          cache_stats=stats, per_epoch=per_epoch, samples_per_s=run["samples_per_s"],
          phase5_samples_per_s=host["samples_per_s"],
          step_ms=1e3 * timed / (steps - WARMUP_STEPS), consumer_wait_share=run["wait"] / timed,
          peak_device_memory_bytes=run["peak"], launches=run["launches"],
          general_resized_crop_launches=run["general_launches"], losses=run["losses"].tolist(),
          decode_stats=run["decode_stats"], targets_match_cpu_order=True,
          adapter={"batches": len(delivered), "seconds": adapter_s,
                   "samples_per_s": N_ROWS / adapter_s,
                   "launches": {"normalize_u8": adapter_launches},
                   "targets_match_cpu_run": True})


def write_labelled_jpegs(path, labels, seed):
    """A dataset of phase 4's schema (``label``, a 224x224 JPEG q90 4:2:0
    ``image``) with the given labels and images from ``seed``."""
    rng = np.random.default_rng(seed)
    schema = Schema("ImageNetJpeg", [
        Field("label", np.int64),
        Field("image", np.uint8, (SIDE, SIDE, 3), CompressedImageCodec("jpeg", quality=90))])
    write_dataset(path, schema, ({"label": int(lab), "image": smooth_image(rng)}
                                 for lab in labels),
                  row_group_size_rows=ROWS_PER_GROUP, encode_workers=os.cpu_count() or 2)


def mix_readers(paths, workers, **kwargs):
    """Phase 17's two device-decode readers and their mix."""
    readers = [make_reader(p, workers_count=workers, shuffle_seed=i, num_epochs=1,
                           decode_placement={"image": "device"}, **kwargs)
               for i, p in enumerate(paths)]
    return WeightedSamplingReader(readers, list(MIX_WEIGHTS), seed=MIX_SEED), readers


def mixed_train_phase(tmp, path, kernels, device):
    """Phase 17: phase 6's training path over a 0.75 / 0.25 mix of phase 6's
    dataset and a second corpus of MIX_ROWS rows, every row of both once."""
    cores = os.cpu_count() or 2
    workers = max(1, min(cores - 1, 16))
    second = os.path.join(tmp, "second_corpus")
    t0 = time.perf_counter()
    write_labelled_jpegs(second, 10_000 + np.random.default_rng(MIX_SEED).permutation(MIX_ROWS),
                         MIX_SEED)
    write_s = time.perf_counter() - t0
    rows = N_ROWS + MIX_ROWS
    mixed, parts = mix_readers([path, second], workers)
    run = train_epoch(None, "device", rows=rows, decoded_images=rows, source=(mixed, parts))
    for name in ("normalize_u8", "resized_crop_flip_u8", "jpeg_decode_u8"):
        kernels[name]["launches"] += run["launches"][name]
    digest = mixed.mixture_digest

    # the replay: the same readers and mixer on the host, batched at BATCH
    replay, _ = mix_readers([path, second], workers)
    with replay:
        cpu_labels = np.concatenate([b.columns["label"] for b in replay.iter_batches()])
    want_digest = replay.mixture_digest
    groups = (N_ROWS + MIX_ROWS) // ROWS_PER_GROUP
    written = np.concatenate(rowgroup_labels(path) + rowgroup_labels(second))
    if not np.array_equal(np.sort(cpu_labels), np.sort(written)):
        raise AssertionError("phase 17: the replay is not every row of both corpora once")
    got = run["labels"].numpy().reshape(-1, BATCH)
    if not np.array_equal(got, cpu_labels.reshape(-1, BATCH)):
        raise AssertionError("phase 17: the card's batches differ from the CPU replay's")
    if digest != want_digest or digest["draw_count"] != groups + 2:
        raise AssertionError(f"phase 17: mixture digest {digest}, replay {want_digest},"
                             f" expected {groups + 2} draws")
    from_second = int((got >= 10_000).sum())
    steps, timed = run["steps"], run["timed"]
    phase("mixed_train_device_decode", decode="device", weights=list(MIX_WEIGHTS),
          corpora_rows=[N_ROWS, MIX_ROWS], second_corpus_write_s=write_s, steps=steps,
          timed_steps=steps - WARMUP_STEPS, batch=BATCH, workers=run["workers"],
          samples_per_s=run["samples_per_s"], phase6_samples_per_s=device["samples_per_s"],
          epoch_s=run["epoch_s"], step_ms=1e3 * timed / (steps - WARMUP_STEPS),
          consumer_wait_share=run["wait"] / timed, peak_device_memory_bytes=run["peak"],
          launches=run["launches"], general_resized_crop_launches=run["general_launches"],
          losses=run["losses"].tolist(), decode_stats=run["decode_stats"],
          mixture_digest=digest, rows_from_second_corpus=from_second,
          labels_match_cpu_replay=True, digest_matches_cpu_replay=True)


def frame_clip_ts(clip, j):
    """Timestamp of frame ``j`` of clip ``clip``: consecutive inside a clip,
    CLIP_GAP between the last frame of a clip and the first of the next."""
    return clip * (CLIP_LEN - 1 + CLIP_GAP) + j


def write_frames(path, seed):
    """Phase 18's frame store: FRAME_GROUPS rowgroups of CLIPS_PER_GROUP
    clips of CLIP_LEN frames (``ts``, the clip's ``label``, a 224x224 JPEG
    q90 ``frame``)."""
    rng = np.random.default_rng(seed)
    schema = Schema("Frames", [
        Field("ts", np.int64), Field("label", np.int64),
        Field("frame", np.uint8, (SIDE, SIDE, 3), CompressedImageCodec("jpeg", quality=90))])
    clips = FRAME_GROUPS * CLIPS_PER_GROUP
    write_dataset(path, schema, ({"ts": frame_clip_ts(c, j), "label": c % 1000,
                                  "frame": smooth_image(rng)}
                                 for c in range(clips) for j in range(CLIP_LEN)),
                  row_group_size_rows=CLIPS_PER_GROUP * CLIP_LEN,
                  encode_workers=os.cpu_count() or 2)


def clip_ngram(stacked=True):
    """4 consecutive frames; the clip's label at the first."""
    fields = {0: ["frame", "ts", "label"], **{k: ["frame", "ts"] for k in range(1, NGRAM_LEN)}}
    return NGram(fields, delta_threshold=1, timestamp_field="ts", stack_timesteps=stacked)


def frames_decoded(plan, length):
    """Frames an epoch of ``plan`` decodes: each item's slice and its
    ``length - 1`` lookahead rows, clipped to the rowgroup."""
    return sum(min(hi + length - 1, item.row_group.num_rows) - lo
               for item in plan.epoch_items(0) for lo, hi in [item.row_slice()])


def ngram_train_phase(tmp, kernels, host, rates):
    """Phase 18: clip training on a frame store through a stacked NGram with
    the lookahead of 2 row-drop partitions; the ngram reader alone; the
    unstacked windows through the torch adapter."""
    cores = os.cpu_count() or 2
    workers = max(1, min(cores - 1, 16))
    path = os.path.join(tmp, "frames")
    t0 = time.perf_counter()
    write_frames(path, 18)
    write_s = time.perf_counter() - t0
    ts_by_group = [pq.ParquetFile(ref.path).read_row_group(ref.row_group, columns=["ts"])
                   .column("ts").to_numpy() for ref in open_dataset(path).row_groups]
    ngram = clip_ngram()
    want_starts = np.sort(np.concatenate([ts[ngram.window_starts(ts)] for ts in ts_by_group]))
    windows = len(want_starts)

    def reader(epochs, ng=ngram, **kwargs):
        return make_reader(path, workers_count=workers, shuffle_seed=0, num_epochs=epochs,
                           ngram=ng, shuffle_row_drop_partitions=2, **kwargs)

    model = ResNet50(num_classes=1000, dtype=torch.bfloat16, device="cuda",
                     generator=torch.Generator().manual_seed(0))
    model = model.to(memory_format=torch.channels_last)
    step = trainer.TrainStep(model, 1000, SIDE,
                             generator=torch.Generator(device="cuda").manual_seed(
                                 trainer.AUGMENT_SEED))
    train_reader = reader(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    starts, losses, steps, staged = [], [], 0, None
    with CudaDataLoader(train_reader, batch_size=NGRAM_BATCH, device="cuda") as loader:
        start = time.perf_counter()
        for batch in loader:
            frames, ts = batch["frame"], batch["ts"]
            if staged is None:
                staged = {k: v.numel() * v.element_size() for k, v in batch.items()}
                if frames.shape != (NGRAM_BATCH, NGRAM_LEN, SIDE, SIDE, 3):
                    raise AssertionError(f"phase 18: frames {tuple(frames.shape)}")
            if not bool((ts == ts[:, :1] + torch.arange(NGRAM_LEN, device=ts.device)).all()):
                raise AssertionError(f"phase 18, step {steps}: a window's ts do not step by 1")
            starts.append(ts[:, 0])
            images = frames.view(-1, SIDE, SIDE, 3)
            labels = batch["0/label"].repeat_interleave(NGRAM_LEN) % 1000
            losses.append(step(images, labels))
            steps += 1
            if steps == WARMUP_STEPS:
                torch.cuda.synchronize()
                timed_start, wait0 = time.perf_counter(), loader.diagnostics()["consumer_wait_s"]
        torch.cuda.synchronize()
        end = time.perf_counter()
        wait = loader.diagnostics()["consumer_wait_s"] - wait0
    launches = {"normalize_u8": normalize.normalize_kernel.launches,
                "resized_crop_flip_u8": augment.resized_crop_kernel.launches_tiled,
                "resized_crop_aa_u8": augment.resized_crop_kernel.launches_aa,
                "jpeg_decode_u8": jpeg.jpeg_decode_kernel.launches_tiled}
    want = {"normalize_u8": steps, "resized_crop_flip_u8": steps, "resized_crop_aa_u8": 0,
            "jpeg_decode_u8": 0}
    if launches != want or augment.resized_crop_kernel.launches_general:
        raise AssertionError(f"phase 18: launches {launches} in {steps} steps, expected {want}")
    for name in ("normalize_u8", "resized_crop_flip_u8"):
        kernels[name]["launches"] += launches[name]
    if steps != windows // NGRAM_BATCH:
        raise AssertionError(f"phase 18: {steps} steps, expected {windows // NGRAM_BATCH}")
    got_starts = np.sort(torch.cat(starts).cpu().numpy())
    if not np.array_equal(got_starts, want_starts):
        raise AssertionError(f"phase 18: {len(got_starts)} window starts, not the"
                             f" {windows} NGram.window_starts gives (lost or doubled)")
    losses = torch.stack(losses).float().cpu()
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"phase 18: non-finite loss {losses.tolist()}")
    per_epoch = frames_decoded(train_reader.plan, NGRAM_LEN)
    decoded = check_native_decode(train_reader.decode_stats(), per_epoch, "phase 18")

    # the ngram reader alone for RATE_EPOCHS epochs
    alone = reader(RATE_EPOCHS)
    count = 0
    with alone:
        t0 = time.perf_counter()
        for b in alone.iter_batches():
            count += b.num_rows
        alone_s = time.perf_counter() - t0
    if count != RATE_EPOCHS * windows:
        raise AssertionError(f"phase 18: the reader alone gave {count} windows")
    check_native_decode(alone.decode_stats(), RATE_EPOCHS * per_epoch, "phase 18, alone")

    # the unstacked windows through the torch adapter onto the card
    flat = reader(1, clip_ngram(stacked=False))
    adapter = torch_adapter.BatchedDataLoader(
        flat, batch_size=NGRAM_BATCH,
        transform_fn=lambda b: {off: {k: v.to("cuda") for k, v in cols.items()}
                                for off, cols in b.items()})
    shapes = []
    with adapter:
        for batch in adapter:
            if set(batch) != set(range(NGRAM_LEN)):
                raise AssertionError(f"phase 18 adapter: offsets {sorted(batch)}")
            for off, cols in batch.items():
                want_fields = {"frame", "ts", "label"} if off == 0 else {"frame", "ts"}
                if set(cols) != want_fields or cols["frame"].shape != (
                        NGRAM_BATCH, SIDE, SIDE, 3) or cols["frame"].device.type != "cuda":
                    raise AssertionError(f"phase 18 adapter: offset {off}: "
                                         f"{ {k: tuple(v.shape) for k, v in cols.items()} }")
                if not bool((cols["ts"] == batch[0]["ts"] + off).all()):
                    raise AssertionError(f"phase 18 adapter: offset {off} ts")
            shapes.append({off: {k: list(v.shape) for k, v in cols.items()}
                           for off, cols in batch.items()})
            if len(shapes) == 4:
                break

    timed = end - timed_start
    timed_steps = steps - WARMUP_STEPS
    phase("ngram_train_host_decode", decode="host", ngram_length=NGRAM_LEN,
          shuffle_row_drop_partitions=2, frames_written=len(ts_by_group) * CLIPS_PER_GROUP
          * CLIP_LEN, frame_store_write_s=write_s, windows_per_epoch=windows, steps=steps,
          timed_steps=timed_steps, windows_per_batch=NGRAM_BATCH,
          frames_per_step=NGRAM_BATCH * NGRAM_LEN, workers=workers,
          samples_per_s=timed_steps * NGRAM_BATCH * NGRAM_LEN / timed,
          windows_per_s=timed_steps * NGRAM_BATCH / timed,
          phase5_samples_per_s=host["samples_per_s"], epoch_s=end - start,
          step_ms=1e3 * timed / timed_steps, consumer_wait_share=wait / timed,
          staged_bytes_per_batch=sum(staged.values()), staged_bytes_by_field=staged,
          peak_device_memory_bytes=torch.cuda.max_memory_allocated(), launches=launches,
          losses=losses.tolist(), decode_stats=decoded, frames_decoded_per_epoch=per_epoch,
          window_starts_match_cpu=True, ts_step_by_one=True,
          reader_alone={"epochs": RATE_EPOCHS, "windows": count, "seconds": alone_s,
                        "windows_per_s": count / alone_s,
                        "frames_decoded_per_s": RATE_EPOCHS * per_epoch / alone_s,
                        "phase7_native_rows_per_s": rates["native"]["rows_per_s"]},
          adapter={"batches": len(shapes), "shapes": shapes[0], "nested_keys_match": True})


def partition_schema():
    """Phase 19's schema: phase 4's ``label`` and JPEG ``image``, the
    ``split`` the rows are partitioned by, and a 14x14 ``mask`` stored with
    ``CompressedNdarrayCodec``."""
    return Schema("ImageNetSplits", [
        Field("label", np.int64), Field("split", np.int64),
        Field("image", np.uint8, (SIDE, SIDE, 3), CompressedImageCodec("jpeg", quality=90)),
        Field("mask", np.uint8, (14, 14), CompressedNdarrayCodec())])


def partition_rows():
    """Phase 4's rows (its labels and images, from the same seed), each with
    its ``split`` (PARTITIONS equal ranges of the row index) and a mask
    drawn from the row's label."""
    rng = np.random.default_rng(0)
    labels = rng.permutation(N_ROWS).astype(np.int64)
    for row, label in enumerate(labels):
        yield {"label": int(label), "split": row // (N_ROWS // PARTITIONS),
               "image": smooth_image(rng), "mask": label_mask(label)}


def label_mask(label):
    return (np.random.default_rng(int(label)).random((14, 14)) > 0.5).astype(np.uint8)


def listing(path):
    """The dataset's rowgroups as (path under the root, rowgroup, rows,
    global index, partition values)."""
    return [(os.path.relpath(r.path, path), r.row_group, r.num_rows, r.global_index,
             r.partition_values) for r in open_dataset(path).row_groups]


def labels_only_digest(path, **kwargs):
    """The stream digest of one epoch of ``path`` read alone on the serial
    pool (the labels only: the digest follows the plan, not the fields)."""
    with make_reader(path, reader_pool_type="serial", shuffle_seed=0,
                     schema_fields=["label", "split"], **kwargs) as reader:
        for _ in reader.iter_batches():
            pass
        return reader.stream_digest


def partitioned_train_phase(tmp, kernels, device):
    """Phase 19: phase 4's rows written as a hive-partitioned corpus (three
    splits in one call, the fourth appended), its metadata rebuilt by
    ``generate_metadata``, then one epoch of phase 6's training path over
    splits 0-2 with the predicate pushed down to the partitions; then a URL
    list of split 3's files through ``make_batch_reader``."""
    path = os.path.join(tmp, "imagenet_splits")
    per_split = N_ROWS // PARTITIONS
    kept_rows = (PARTITIONS - 1) * per_split
    cores = os.cpu_count() or 2
    t0 = time.perf_counter()
    schema, rows = partition_schema(), partition_rows()
    write_dataset(path, schema, itertools.islice(rows, kept_rows), partition_by=["split"],
                  row_group_size_rows=ROWS_PER_GROUP, rows_per_file=ROWS_PER_GROUP,
                  encode_workers=cores)
    write_dataset(path, schema, rows, partition_by=["split"],
                  row_group_size_rows=ROWS_PER_GROUP, rows_per_file=ROWS_PER_GROUP,
                  encode_workers=cores, mode="append")
    write_s = time.perf_counter() - t0
    before, digest_before = listing(path), labels_only_digest(path)
    if [dict(p)["split"] for *_, p in before] != [str(i // (per_split // ROWS_PER_GROUP))
                                                  for i in range(N_ROWS // ROWS_PER_GROUP)]:
        raise AssertionError(f"phase 19: partitions {before}")
    os.remove(os.path.join(path, "_common_metadata"))
    t0 = time.perf_counter()
    generate_metadata(path)
    regenerate_s = time.perf_counter() - t0
    if listing(path) != before or labels_only_digest(path) != digest_before:
        raise AssertionError("phase 19: the regenerated metadata reads another rowgroup list"
                             " or stream than the written one")

    pushdown = {"predicate": in_set(set(range(PARTITIONS - 1)), "split")}
    masks = []
    run = train_epoch(path, "device", reader_kwargs=pushdown, rows=kept_rows,
                      decoded_images=kept_rows, loader_kwargs={"host_fields": ["mask"]},
                      on_batch=lambda b: masks.append(b["mask"]))
    for name in ("normalize_u8", "resized_crop_flip_u8", "jpeg_decode_u8"):
        kernels[name]["launches"] += run["launches"][name]
    cpu_labels, _, cpu_digest = cpu_reader_run(path, num_epochs=1, shuffle_seed=0,
                                               decode_placement={"image": "device"},
                                               **pushdown)
    cpu_labels = np.concatenate(cpu_labels)
    if len(cpu_labels) != kept_rows or run["steps"] * BATCH != kept_rows:
        raise AssertionError(f"phase 19: {len(cpu_labels)} rows on the CPU, {run['steps']}"
                             f" steps on the card, expected {kept_rows} rows")
    if not np.array_equal(run["labels"].numpy(), cpu_labels):
        raise AssertionError("phase 19: the card delivered other labels, or in another order,"
                             " than the reader alone on the CPU")
    if run["digest"] != cpu_digest:
        raise AssertionError("phase 19: the stream digest differs from the CPU run's")
    # the masks are host fields: read after the run, so the timed steps
    # never wait for the card
    for labels, mask in zip(run["labels"].numpy().reshape(-1, BATCH), masks):
        if mask.shape != (BATCH, 14, 14) or not all(
                np.array_equal(m, label_mask(lab)) for lab, m in zip(labels, mask)):
            raise AssertionError("phase 19: a delivered mask differs from the written one")

    # split 3 alone, from the list of its files
    files = sorted(os.path.join(d, f) for d, _, names in os.walk(path) for f in names
                   if f.endswith(".parquet") and f"split={PARTITIONS - 1}" in d)
    with make_batch_reader(["file://" + f for f in files], schema_fields=["label", "split"],
                           reader_pool_type="serial", shuffle_seed=0) as reader:
        cols = [b.columns for b in reader.iter_batches()]
    split = np.concatenate([c["split"] for c in cols])
    if len(split) != per_split or not (split == PARTITIONS - 1).all():
        raise AssertionError(f"phase 19: the URL list read {len(split)} rows of splits"
                             f" {sorted(set(split.tolist()))}")
    steps, timed = run["steps"], run["timed"]
    phase("partitioned_train_device_decode", decode="device", partitions=PARTITIONS,
          rows_written=N_ROWS, rows_kept=kept_rows, files=len(before), write_s=write_s,
          regenerate_metadata_s=regenerate_s, steps=steps, timed_steps=steps - WARMUP_STEPS,
          batch=BATCH, workers=run["workers"], samples_per_s=run["samples_per_s"],
          phase6_samples_per_s=device["samples_per_s"], epoch_s=run["epoch_s"],
          step_ms=1e3 * timed / (steps - WARMUP_STEPS),
          consumer_wait_share=run["wait"] / timed, peak_device_memory_bytes=run["peak"],
          launches=run["launches"], losses=run["losses"].tolist(),
          decode_stats=run["decode_stats"], labels_match_cpu_reader=True,
          digest_matches_cpu_reader=True, masks_match_written=True,
          regenerated_metadata_matches=True, url_list_rows=int(len(split)))
    return path


def poison(path):
    """Two rowgroups of different splits made unreadable: split 1's first
    file rewritten (through ``materialize_dataset`` and pyarrow) with image
    cell POISON_CELL cut inside its JPEG header, and split 2's first file
    overwritten with garbage bytes.  Returns their paths."""
    files = sorted(os.path.join(d, f) for d, _, names in os.walk(path) for f in names
                   if f.endswith(".parquet"))
    cut = next(f for f in files if "split=1" in f)
    garbage = next(f for f in files if "split=2" in f)
    with materialize_dataset(path, partition_schema()):
        table = pq.ParquetFile(cut).read()
        cells = table.column("image").to_pylist()
        cells[POISON_CELL] = cells[POISON_CELL][:40]
        table = table.set_column(table.schema.get_field_index("image"), "image",
                                 pa.array(cells, type=pa.binary()))
        pq.write_table(table, cut, row_group_size=ROWS_PER_GROUP)
    size = os.path.getsize(garbage)
    with open(garbage, "wb") as f:
        f.write(b"\x13" * size)
    return cut, garbage


def poisoned_train_phase(tmp, part_path, kernels, host, device):
    """Phase 20: phase 19's corpus with two poisoned rowgroups, one epoch
    over all splits under ``on_error=ErrorPolicy(max_skipped_rowgroups=2)``
    through phase 6's device-decode path, then phase 5's host-decode path;
    then the budget of 1 refused from the loader's ``next()``."""
    path = os.path.join(tmp, "imagenet_splits_poisoned")
    shutil.copytree(part_path, path)
    cut, garbage = poison(path)
    rows = N_ROWS - 2 * ROWS_PER_GROUP
    policy = {"on_error": ErrorPolicy(max_skipped_rowgroups=2)}
    cpu_labels, _, cpu_digest = cpu_reader_run(path, num_epochs=1, shuffle_seed=0,
                                               decode_placement={"image": "device"}, **policy)
    cpu_labels = np.concatenate(cpu_labels)
    if len(cpu_labels) != rows:
        raise AssertionError(f"phase 20: the CPU reader delivered {len(cpu_labels)} rows,"
                             f" expected {rows}")
    results = {}
    for decode, names in (("device", ("normalize_u8", "resized_crop_flip_u8", "jpeg_decode_u8")),
                          ("host", ("normalize_u8", "resized_crop_flip_u8"))):
        run = train_epoch(path, decode, reader_kwargs=policy, rows=rows, decoded_images=rows,
                          loader_kwargs={"host_fields": ["mask"]})
        for name in names:
            kernels[name]["launches"] += run["launches"][name]
        diag = run["diagnostics"]
        quarantined = sorted((e["path"], e["kind"]) for e in diag.get("quarantined_rowgroups", []))
        if diag.get("skipped_rowgroups") != 2 or quarantined != sorted(
                [(cut, "data"), (garbage, "data")]):
            raise AssertionError(f"phase 20, {decode} decode: quarantine {diag}")
        if run["steps"] * BATCH != rows or not np.array_equal(run["labels"].numpy(), cpu_labels):
            raise AssertionError(f"phase 20, {decode} decode: other labels than the CPU reader")
        if run["digest"] != cpu_digest:
            raise AssertionError(f"phase 20, {decode} decode: digest differs from the CPU run's")
        if run["state"]["position"] != N_ROWS // ROWS_PER_GROUP:
            raise AssertionError(f"phase 20, {decode} decode: cursor {run['state']}")
        results[decode] = {
            "samples_per_s": run["samples_per_s"], "consumer_wait_share": run["wait"] / run["timed"],
            "steps": run["steps"], "epoch_s": run["epoch_s"], "launches": run["launches"],
            "losses": run["losses"].tolist(), "decode_stats": run["decode_stats"],
            "quarantined": [{k: e[k] for k in ("ordinal", "row_group", "kind", "exc_type")}
                            for e in diag["quarantined_rowgroups"]]}

    # a budget of 1: the second skip raises from the loader's next()
    workers = max(1, min((os.cpu_count() or 2) - 1, 16))
    reader = make_reader(path, workers_count=workers, shuffle_seed=0, num_epochs=1,
                         decode_placement={"image": "device"},
                         on_error=ErrorPolicy(max_skipped_rowgroups=1))
    loader = CudaDataLoader(reader, batch_size=BATCH, device="cuda", host_fields=["mask"])
    delivered, error = 0, None
    t0 = time.perf_counter()
    try:
        for _ in loader:
            delivered += 1
    except ErrorBudgetExceededError as exc:
        error = exc
    refuse_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    for thread in (loader._thread, loader._transfer_thread):
        thread.join(timeout=10)
    alive = [t.name for t in (loader._thread, loader._transfer_thread) if t.is_alive()]
    loader.stop()
    if error is None or error.diagnostics.get("skipped_rowgroups") != 2 or alive:
        raise AssertionError(f"phase 20: the budget of 1 gave {error!r} after {delivered}"
                             f" batches; loader threads alive: {alive}")
    if refuse_s > 60:
        raise AssertionError(f"phase 20: the budget refusal took {refuse_s:.1f} s")
    phase("poisoned_train", rows_written=N_ROWS, rows_delivered=rows,
          poisoned={"cut_jpeg_cell": os.path.relpath(cut, path),
                    "garbage_file": os.path.relpath(garbage, path)},
          device_decode=results["device"], host_decode=results["host"],
          phase6_samples_per_s=device["samples_per_s"],
          phase5_samples_per_s=host["samples_per_s"],
          labels_match_cpu_reader=True, digest_matches_cpu_reader=True,
          budget_of_1={"raised": type(error).__name__, "batches_before": delivered,
                       "seconds": refuse_s, "skipped_rowgroups": 2,
                       "loader_threads_ended": True})


MIXED_ROWS, MIXED_EPOCHS, MIXED_SEED = 2048, 2, 21   # phase 21: the corpus, epochs trained
MIXED_TARGET = (500, 500, 3)                          # phase 21: the pad_shapes target
#: phase 21's geometries: (weight, (h, w), cv2 sampling factor or None for
#: 4:2:0, grayscale), ImageNet's common sizes
MIXED_KINDS = ((0.4, (375, 500), None, False), (0.2, (500, 375), None, False),
               (0.2, (333, 500), None, False),
               (0.1, (500, 500), "IMWRITE_JPEG_SAMPLING_FACTOR_444", False),
               (0.1, (375, 500), None, True))


def mixed_schema():
    return Schema("ImageNetMixed", [
        Field("label", np.int64),
        Field("image", np.uint8, (None, None, 3), CompressedImageCodec("jpeg", quality=90))])


def write_mixed_corpus(path):
    """Phase 21's corpus: MIXED_ROWS cv2-encoded JPEGs (q90) of the
    MIXED_KINDS geometries drawn with their weights from MIXED_SEED, label i
    on row i, in rowgroups of ROWS_PER_GROUP, with the geometry contract
    stamped.  Returns (the streams, each row's kind)."""
    import cv2

    rng = np.random.default_rng(MIXED_SEED)
    kinds = rng.choice(len(MIXED_KINDS), MIXED_ROWS, p=[k[0] for k in MIXED_KINDS])
    lows = rng.integers(0, 256, (MIXED_ROWS, 7, 7, 3)).astype(np.float32)
    # photograph-like entropy from a few shared noise fields (drawing one a
    # row would cost more than the encode)
    noise = rng.normal(0.0, 8.0, (4, 500, 500, 3)).astype(np.float32)

    def encode(i):
        _, (h, w), sampling, gray = MIXED_KINDS[kinds[i]]
        img = cv2.resize(lows[i], (w, h), interpolation=cv2.INTER_CUBIC) + noise[i % 4, :h, :w]
        img = np.clip(img, 0, 255).astype(np.uint8)
        params = [int(cv2.IMWRITE_JPEG_QUALITY), 90]
        if sampling is not None:
            params += [int(cv2.IMWRITE_JPEG_SAMPLING_FACTOR), int(getattr(cv2, sampling))]
        return cv2.imencode(".jpeg", img[..., 0] if gray else img, params)[1].tobytes()

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 2) as pool:
        bufs = list(pool.map(encode, range(MIXED_ROWS)))
    os.makedirs(path)
    schema = mixed_schema()
    pq.write_table(pa.Table.from_pylist([{"label": i, "image": b} for i, b in enumerate(bufs)],
                                        schema=schema.as_arrow_schema()),
                   os.path.join(path, "part-00000.parquet"), row_group_size=ROWS_PER_GROUP)
    stamp_dataset_metadata(path, schema, geometries={"image": sorted(
        {(h, w, 1 if gray else 3) for _, (h, w), _, gray in MIXED_KINDS})})
    return bufs, kinds


def mixed_first_batch_checks(path, images, labels, bufs, kinds):
    """Phase 21's first delivered batch (``images`` (BATCH, *MIXED_TARGET) on
    the card, ``labels`` its rows): each geometry bucket's B2 decode (the
    tiled kernel, as the loader ran it on the same planes in the same order)
    equal to the general kernel and within B2's bound of the plain version
    (``check_jpeg``); each delivered row equal to that decode, cropped and
    (grayscale) repeated, and against cv2's decode under ``within_cv2``'s
    rule; the pad region zero.  Then the loader's own decode of the first
    rowgroup (its pack, copy and bucket decodes, timed by CUDA events), a
    pinned arena's allocation, and B2's launches of those buckets from a
    CUDA graph, each bucket and all five, beside their bounds.  Returns the
    checks and times."""
    checks, bucket_calls = {}, []
    read = written = flops = 0
    for kind in sorted(set(kinds[labels].tolist())):
        rows = np.flatnonzero(kinds[labels] == kind)
        _, (h, w), _, gray = MIXED_KINDS[kind]
        group = [bufs[label] for label in labels[rows]]
        planes, qtabs, layout = native_image.read_jpeg_coefficients_column(group)
        dp = [torch.from_numpy(p).cuda() for p in planes]
        dq = torch.from_numpy(qtabs.astype(np.int32)).cuda()
        name = f"{h}x{w} {'gray' if gray else layout.sampling}"
        err, share = check_jpeg(dp, dq, layout, torch.uint8, f"phase 21, {name}")
        b2 = jpeg.decode_from_layout(dp, dq, layout)
        plain = jpeg._decode_reference(dp, dq, (h, w), layout.sampling)
        got = images[torch.from_numpy(rows).cuda()]
        crop = got[:, :h, :w]
        want = b2[..., None].expand(-1, -1, -1, 3) if gray else b2
        if not torch.equal(crop, want):
            raise AssertionError(f"phase 21, {name}: the delivered rows differ from B2's"
                                 " decode of their planes")
        if got[:, h:].any() or got[:, :, w:].any():
            raise AssertionError(f"phase 21, {name}: the pad region is not zero")
        if gray and not (torch.equal(crop[..., 0], crop[..., 1])
                         and torch.equal(crop[..., 0], crop[..., 2])):
            raise AssertionError(f"phase 21, {name}: a grayscale row's channels differ")
        vs_cv2 = within_cv2(crop[..., 0].cpu().numpy() if gray else crop.cpu().numpy(),
                            cv2_decode(group), plain.cpu().numpy(), f"phase 21, {name}")
        r, wr, f = jpeg_bound(layout, len(rows))
        read, written, flops = read + r, written + wr, flops + f
        bucket_calls.append(lambda dp=dp, dq=dq, layout=layout: jpeg.jpeg_decode_kernel(
            dp, dq, (layout.height, layout.width), layout.sampling))
        bound = max(1e3 * (r + wr) / HBM_BYTES_PER_S, 1e3 * f / F32_FLOPS_PER_S)
        ms = time_graph_ms(bucket_calls[-1])
        checks[name] = {"rows": int(len(rows)), "vs_plain_max_abs_err": err,
                        "vs_plain_share_differing": share, "vs_cv2": vs_cv2,
                        "instance": jpeg.decode_launch_plan(
                            len(rows), (h, w), tuple(layout.sampling),
                            tuple(tuple(p.shape[1:3]) for p in dp), True,
                            jpeg._sm_count(torch.cuda.current_device())).kind,
                        "b2_ms_from_graph": ms, "bound_ms": bound, "share_of_bound": bound / ms}
    b2_ms = time_graph_ms(lambda: [call() for call in bucket_calls])
    bytes_ms, ops_ms = 1e3 * (read + written) / HBM_BYTES_PER_S, 1e3 * flops / F32_FLOPS_PER_S

    # the loader's own code on the first rowgroup: pack into a pinned arena,
    # one copy, B2 a bucket and the fit, back to back between CUDA events
    reader = make_reader(path, workers_count=1, shuffle_seed=0, num_epochs=1,
                         decode_placement={"image": "device-mixed"})
    loader = CudaDataLoader(reader, batch_size=BATCH, device="cuda",
                            pad_shapes={"image": MIXED_TARGET})
    with reader:
        item = loader._prep_cols(loader._prepare(next(reader.iter_batches())))
    loader.stop()
    slot = loader._slot(loader._layout(item))
    arena, buckets = loader._pack_mixed("image", [item], slot.arena)
    dev = arena.cuda()
    if not np.array_equal(item.cols["label"], labels) or not torch.equal(
            loader._decode_mixed("image", dev, buckets), images):
        raise AssertionError("phase 21: the loader's decode of the first rowgroup is not the"
                             " first delivered batch")
    t0 = time.perf_counter()
    for _ in range(5):
        loader._pack_mixed("image", [item], slot.arena)
    pack_ms = 1e3 * (time.perf_counter() - t0) / 5
    t0 = time.perf_counter()
    torch.empty(arena.numel(), dtype=torch.uint8, pin_memory=True)
    pin_ms = 1e3 * (time.perf_counter() - t0)
    return checks, {
        "buckets": len(buckets), "b2_ms_from_graph": b2_ms,
        "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms
        else "operations", "share_of_bound": max(bytes_ms, ops_ms) / b2_ms,
        "bytes_read": read, "bytes_written": written, "flops": flops,
        "staged_bytes": int(arena.numel()),
        "pack_host_ms": pack_ms, "pinned_arena_alloc_ms": pin_ms,
        "copy_ms": time_ms(lambda: arena.to("cuda", non_blocking=True), samples=11, launches=3),
        "decode_and_fit_ms": time_ms(lambda: loader._decode_mixed("image", dev, buckets),
                                     samples=11, launches=3)}


def mixed_geometry_train_phase(tmp, kernels, device):
    """Phase 21: a corpus of ImageNet's mixed JPEG geometries read with
    ``decode_placement={'image': 'device-mixed'}`` into phase 6's training
    path, the loader fitting every image to (500, 500, 3), for MIXED_EPOCHS
    epochs; B2 once a geometry bucket a batch."""
    path = os.path.join(tmp, "imagenet_mixed_geometry")
    t0 = time.perf_counter()
    bufs, kinds = write_mixed_corpus(path)
    write_s = time.perf_counter() - t0
    rows = MIXED_EPOCHS * MIXED_ROWS
    run = train_epoch(path, "device-mixed", epochs=MIXED_EPOCHS, rows=rows, decoded_images=rows,
                      loader_kwargs={"pad_shapes": {"image": MIXED_TARGET}})
    for name in ("normalize_u8", "resized_crop_flip_u8", "jpeg_decode_u8"):
        kernels[name]["launches"] += run["launches"][name]
    labels = run["labels"].numpy()
    steps, timed, diag = run["steps"], run["timed"], run["diagnostics"]
    buckets = [len(set(kinds[labels[k * BATCH:(k + 1) * BATCH]].tolist())) for k in range(steps)]
    if run["launches"]["jpeg_decode_u8"] != sum(buckets) or diag["mixed_buckets"] != sum(buckets):
        raise AssertionError(f"phase 21: B2 launched {run['launches']['jpeg_decode_u8']} times,"
                             f" the loader decoded {diag['mixed_buckets']} buckets, the batches"
                             f" hold {sum(buckets)} geometry buckets")
    if diag["mixed_decode_geometries"] != {"image": len(MIXED_KINDS)}:
        raise AssertionError(f"phase 21: geometries {diag['mixed_decode_geometries']}")
    for epoch in range(MIXED_EPOCHS):
        if not np.array_equal(np.sort(labels[epoch * MIXED_ROWS:(epoch + 1) * MIXED_ROWS]),
                              np.arange(MIXED_ROWS)):
            raise AssertionError(f"phase 21: epoch {epoch} is not every row once")
    cpu_labels, _, cpu_digest = cpu_reader_run(path, num_epochs=MIXED_EPOCHS, shuffle_seed=0,
                                               decode_placement={"image": "device-mixed"})
    if not np.array_equal(labels, np.concatenate(cpu_labels)) or run["digest"] != cpu_digest:
        raise AssertionError("phase 21: other labels, order or digest than the reader alone"
                             " on the CPU")
    first_images = run.pop("first")[0]
    del run["model"], run["step"]
    checks, decode = mixed_first_batch_checks(path, first_images, labels[:BATCH], bufs, kinds)
    units = diag["units_staged"]
    phase("mixed_geometry_train_device_decode", decode="device-mixed", rows=MIXED_ROWS,
          epochs=MIXED_EPOCHS, corpus_write_s=write_s, target=list(MIXED_TARGET),
          kinds={f"{h}x{w} {'gray' if g else ('4:4:4' if s else '4:2:0')}":
                 int((kinds == i).sum())
                 for i, (_, (h, w), s, g) in enumerate(MIXED_KINDS)},
          steps=steps, timed_steps=steps - WARMUP_STEPS, batch=BATCH, workers=run["workers"],
          samples_per_s=run["samples_per_s"], phase6_samples_per_s=device["samples_per_s"],
          relative_to_phase6=run["samples_per_s"] / device["samples_per_s"] - 1,
          epoch_s=run["epoch_s"], step_ms=1e3 * timed / (steps - WARMUP_STEPS),
          consumer_wait_share=run["wait"] / timed, peak_device_memory_bytes=run["peak"],
          launches=run["launches"], b2_launches_per_step=sum(buckets) / steps,
          buckets_per_batch=buckets, mixed_decode_geometries=diag["mixed_decode_geometries"],
          declared_geometries=diag.get("declared_geometries"),
          loader_mixed_host_ms_per_batch=1e3 * diag["mixed_decode_s"] / units,
          transfer_ms_per_batch=1e3 * diag["transfer_s"] / units,
          assemble_ms_per_batch=1e3 * diag["assemble_s"] / units,
          first_batch_decode=decode, first_batch_checks=checks, losses=run["losses"].tolist(),
          decode_stats=run["decode_stats"], labels_match_cpu_reader=True,
          digest_matches_cpu_reader=True)


def converter_table(path):
    """Phase 4's rows (its labels and stored JPEG bytes) as one arrow table."""
    import pyarrow.dataset as pads

    return pads.dataset(path, format="parquet").to_table(columns=["label", "image"])


def decode_converted(cols):
    """The converter's JPEG bytes column (binary in its inferred schema, as
    the reference's converter leaves it) decoded in one native call."""
    images = np.empty((len(cols["image"]), SIDE, SIDE, 3), np.uint8)
    native_image.decode_column_native(pa.array(list(cols["image"]), pa.binary()), images)
    return {"label": cols["label"], "image": images}


def converter_train_phase(tmp, path, kernels, host):
    """Phase 22: phase 4's rows as an arrow table through ``make_converter``
    (rowgroups of BATCH rows) and ``make_cuda_loader`` into phase 5's
    host-decode training path, the JPEG bytes decoded by a ``TransformSpec``
    in one native call a rowgroup, for one epoch; a second conversion of the
    same table returns the cached dataset without writing; then
    ``delete()``."""
    table = converter_table(path)
    cache = os.path.join(tmp, "converter_cache")
    # rowgroups of BATCH rows, as phase 4's
    rg_mb = (BATCH + 0.5) * table.nbytes / table.num_rows / 2 ** 20
    t0 = time.perf_counter()
    conv = make_converter(table, cache_dir_url=cache, row_group_size_mb=rg_mb)
    write_s = time.perf_counter() - t0
    mtimes = {f: os.stat(f).st_mtime_ns for f in conv.file_urls}
    t0 = time.perf_counter()
    again = make_converter(table, cache_dir_url=cache, row_group_size_mb=rg_mb)
    again_s = time.perf_counter() - t0
    if again is not conv or {f: os.stat(f).st_mtime_ns for f in conv.file_urls} != mtimes:
        raise AssertionError("phase 22: a second conversion of the table wrote again")
    groups = pq.ParquetFile(conv.file_urls[0]).metadata.num_row_groups
    if len(conv) != N_ROWS or groups != N_ROWS // ROWS_PER_GROUP:
        raise AssertionError(f"phase 22: {len(conv)} rows in {groups} rowgroups")
    workers = max(1, min((os.cpu_count() or 2) - 1, 16))
    spec = TransformSpec(decode_converted, edit_fields=[("image", np.uint8, (SIDE, SIDE, 3),
                                                         False)])
    loader = conv.make_cuda_loader(BATCH, device="cuda", reader_kwargs={
        "workers_count": workers, "shuffle_seed": 0, "num_epochs": 1, "transform_spec": spec})
    reader = loader._reader
    run = train_epoch(None, "host", rows=N_ROWS, decoded_images=N_ROWS,
                      source=(reader, [reader]), loader=loader)
    for name in ("normalize_u8", "resized_crop_flip_u8"):
        kernels[name]["launches"] += run["launches"][name]
    cpu_labels, _, cpu_digest = cpu_reader_run(conv.cache_url, shuffle_seed=0, num_epochs=1,
                                               schema_fields=["label"])
    if not np.array_equal(run["labels"].numpy(), np.concatenate(cpu_labels)) or (
            run["digest"] != cpu_digest):
        raise AssertionError("phase 22: other labels, order or digest than the reader alone"
                             " on the CPU")
    if not np.array_equal(np.sort(run["labels"].numpy()), np.sort(host["labels"].numpy())):
        raise AssertionError("phase 22: the converted rows are not phase 5's")
    first_images, first_labels = run["first"][0].cpu().numpy(), run["labels"][:BATCH].numpy()
    index = {int(label): i for i, label in enumerate(table.column("label").to_pylist())}
    want = cv2_decode([table.column("image")[index[int(label)]].as_py()
                       for label in first_labels])
    if not np.array_equal(first_images, want):
        raise AssertionError("phase 22: the first batch differs from cv2's decode of its rows")
    del run["model"], run["step"], run["first"]
    url = conv.cache_url
    conv.delete()
    if os.path.exists(url):
        raise AssertionError("phase 22: delete() left the cached dataset")
    steps, timed = run["steps"], run["timed"]
    phase("converter_train_host_decode", decode="host (TransformSpec, native batched call)",
          rows=N_ROWS, rowgroups=groups, convert_write_s=write_s,
          second_convert_s=again_s, second_convert_wrote=False, steps=steps,
          timed_steps=steps - WARMUP_STEPS, batch=BATCH, workers=run["workers"],
          samples_per_s=run["samples_per_s"], phase5_samples_per_s=host["samples_per_s"],
          relative_to_phase5=run["samples_per_s"] / host["samples_per_s"] - 1,
          epoch_s=run["epoch_s"], step_ms=1e3 * timed / (steps - WARMUP_STEPS),
          consumer_wait_share=run["wait"] / timed, peak_device_memory_bytes=run["peak"],
          launches=run["launches"], losses=run["losses"].tolist(),
          decode_stats=run["decode_stats"], labels_match_cpu_reader=True,
          digest_matches_cpu_reader=True, first_batch_equals_cv2=True, deleted=True)


def write_token_corpus(path, n_docs, seed):
    """A token corpus written in bulk as one Parquet file: ``doc_id``,
    ``n_tokens`` and an int32 ``token_field`` in rowgroups of TOKEN_GROUP,
    lognormal lengths (median TOKEN_MEDIAN, cut at TOKEN_MAX), ids uniform in
    [0, TOKEN_VOCAB).  Returns (tokens, documents longer than TOKEN_SEQ_LEN)."""
    rng = np.random.default_rng(seed)
    lengths = np.clip(np.rint(rng.lognormal(np.log(TOKEN_MEDIAN), TOKEN_SIGMA, n_docs)),
                      1, TOKEN_MAX).astype(np.int64)
    offsets = np.zeros(n_docs + 1, np.int64)
    np.cumsum(lengths, out=offsets[1:])
    tokens = rng.integers(0, TOKEN_VOCAB, int(offsets[-1]), dtype=np.int32)
    schema = Schema("TokenCorpus", [Field("doc_id", np.int64), Field("n_tokens", np.int32),
                                    token_field()])
    table = pa.Table.from_arrays(
        [pa.array(np.arange(n_docs, dtype=np.int64)), pa.array(lengths.astype(np.int32)),
         pa.ListArray.from_arrays(pa.array(offsets.astype(np.int32)), pa.array(tokens))],
        schema=schema.as_arrow_schema())
    os.makedirs(path)
    pq.write_table(table, os.path.join(path, "part-00000.parquet"), row_group_size=TOKEN_GROUP)
    stamp_dataset_metadata(path, schema)
    return int(offsets[-1]), int((lengths > TOKEN_SEQ_LEN).sum())


def token_feed_phase(tmp):
    """Phase 23: two token corpora mixed, packed and delivered to the card by
    ``make_packed_sequence_loader`` to exhaustion; the delivered stream's
    digest against a CPU packing of the same mixture."""
    t0 = time.perf_counter()
    urls, written = [], []
    for i, n_docs in enumerate(TOKEN_DOCS):
        urls.append(os.path.join(tmp, f"tokens_{i}"))
        written.append(write_token_corpus(urls[-1], n_docs, 230 + i))
    write_s = time.perf_counter() - t0
    total_tokens, long_docs = map(sum, zip(*written))
    kwargs = dict(weights=list(TOKEN_WEIGHTS), seed=TOKEN_SEED)
    batches = []
    start = time.perf_counter()
    with make_packed_sequence_loader(urls, batch_size=TOKEN_BATCH, seq_len=TOKEN_SEQ_LEN,
                                     long_docs="split", device="cuda",
                                     loader_kwargs={"drop_last": False}, **kwargs) as loader:
        for batch in loader:
            if not batches:
                first, wait0 = time.perf_counter(), loader.diagnostics()["consumer_wait_s"]
            batches.append(batch)
        torch.cuda.synchronize()
        end = time.perf_counter()
        diagnostics = loader.diagnostics()
    packed = diagnostics["reader"]
    dtypes = {"tokens": torch.int32, "segment_ids": torch.int32, "positions": torch.int32,
              "loss_mask": torch.float32}
    delivered = []
    for batch in batches:
        for name, dtype in dtypes.items():
            col = batch[name]
            if col.device.type != "cuda" or col.dtype != dtype or (
                    tuple(col.shape) != (TOKEN_BATCH, TOKEN_SEQ_LEN)):
                raise AssertionError(f"phase 23: {name} delivered as {col.dtype}"
                                     f" {tuple(col.shape)} on {col.device}")
        rows = int(batch.get(VALID_ROWS, TOKEN_BATCH))
        delivered.append({name: batch[name][:rows].cpu().numpy() for name in dtypes})
    del batches
    rows = sum(len(b["tokens"]) for b in delivered)
    digest = packed_stream_digest(delivered)
    real_tokens = sum(int(np.count_nonzero(b["loss_mask"])) for b in delivered)
    t0 = time.perf_counter()
    packer = SequencePacker(TOKEN_SEQ_LEN, long_docs="split")
    with make_mixed_sequence_reader(urls, **kwargs) as mixer:
        cpu_digest = packed_stream_digest(iter_packed_blocks(
            iter_documents(mixer), TOKEN_SEQ_LEN, TOKEN_BATCH, packer=packer))
    cpu_pack_s = time.perf_counter() - t0
    # the mixed reader alone, decoding the documents and packing nothing
    t0 = time.perf_counter()
    with make_mixed_sequence_reader(urls, **kwargs) as mixer:
        read_tokens = sum(len(doc) for doc in iter_documents(mixer))
    read_s = time.perf_counter() - t0
    if read_tokens != total_tokens:
        raise AssertionError(f"phase 23: the reader alone read {read_tokens} tokens")
    stats = packed["packing"]
    if digest != cpu_digest or stats != packer.stats():
        raise AssertionError(f"phase 23: the card's packed stream (digest {digest:08x}, {stats})"
                             f" differs from the CPU packing ({cpu_digest:08x}, {packer.stats()})")
    if (stats["docs"] != sum(TOKEN_DOCS) or stats["docs_split"] != long_docs
            or stats["tokens"] != total_tokens or stats["rows"] != rows
            or real_tokens != total_tokens or not long_docs):
        raise AssertionError(f"phase 23: packed {stats}, {rows} rows and {real_tokens} tokens"
                             f" delivered, {total_tokens} tokens and {long_docs} long"
                             f" documents written")
    timed = end - first
    wait = diagnostics["consumer_wait_s"] - wait0
    phase("token_feed", corpora_docs=list(TOKEN_DOCS), weights=list(TOKEN_WEIGHTS),
          seed=TOKEN_SEED, seq_len=TOKEN_SEQ_LEN, batch=TOKEN_BATCH, rowgroup_rows=TOKEN_GROUP,
          tokens_written=total_tokens, long_docs=long_docs, write_s=write_s,
          batches=len(delivered), rows=rows, wall_s=end - start, timed_s=timed,
          tokens_per_s=real_tokens / timed, slots_per_s=rows * TOKEN_SEQ_LEN / timed,
          rows_per_s=rows / timed, consumer_wait_share=wait / timed,
          consumer_wait_share_wall=diagnostics["consumer_wait_s"] / (end - start),
          assemble_s=diagnostics["assemble_s"], transfer_s=diagnostics["transfer_s"],
          fill_rate=stats["fill_rate"], docs=stats["docs"], docs_split=stats["docs_split"],
          mixture_draws=packed["source"]["mixture_digest"]["draw_count"],
          digest=f"{digest:08x}", digest_matches_cpu_packing=True, cpu_pack_s=cpu_pack_s,
          cpu_pack_tokens_per_s=total_tokens / cpu_pack_s, reader_alone_s=read_s,
          reader_alone_tokens_per_s=total_tokens / read_s)


def mnist_phase(tmp, kernels):
    """Phase 24: B1 at the MNIST step's shape against its plain version, then
    one epoch of ``train_mnist_cuda.train`` over MNIST_ROWS rows, then the
    hello-world and preemption examples on the card."""
    gen = torch.Generator(device="cuda").manual_seed(24)
    x = torch.randint(0, 256, (MNIST_BATCH, 28, 28, 1), dtype=torch.uint8, device="cuda",
                      generator=gen)
    err = check_normalize(x, 0.5, 0.5, torch.bfloat16)
    scale, bias = normalize.channel_constants(0.5, 0.5, 1)
    n = x.numel()
    b1 = {"shape": list(x.shape), "out": "bfloat16", "max_abs_err": err,
          "ms": time_ms(lambda: normalize.normalize_kernel(x, scale, bias, torch.bfloat16)),
          "graph_ms": time_graph_ms(lambda: normalize.normalize_kernel(x, scale, bias,
                                                                       torch.bfloat16)),
          "plain_ms": time_ms(lambda: normalize._normalize_reference(x, scale, bias,
                                                                     torch.bfloat16)),
          "bytes_read": n, "bytes_written": 2 * n,
          "bound_ms": 1e3 * max(3 * n / HBM_BYTES_PER_S, 2 * n / F32_FLOPS_PER_S),
          "bound_by": "bytes"}

    url = os.path.join(tmp, "mnist")
    t0 = time.perf_counter()
    mnist.generate_dataset(url, MNIST_ROWS)
    write_s = time.perf_counter() - t0
    plain_calls = []
    real_plain = normalize._normalize_reference

    def counting_plain(*args):
        plain_calls.append(1)
        return real_plain(*args)

    torch.cuda.synchronize()
    reset_launch_counts()
    normalize._normalize_reference = counting_plain
    try:
        result = mnist.train(url, epochs=1, batch_size=MNIST_BATCH, device="cuda",
                             verbose=False)
    finally:
        normalize._normalize_reference = real_plain
    epoch = result["epochs"][0]
    launches = normalize.normalize_kernel.launches
    others = (augment.resized_crop_kernel.launches, jpeg.jpeg_decode_kernel.launches)
    if epoch["steps"] != MNIST_ROWS // MNIST_BATCH or launches != epoch["steps"] or (
            plain_calls or any(others)):
        raise AssertionError(f"phase 24: {epoch['steps']} steps, B1 launched {launches} times,"
                             f" its plain version {len(plain_calls)}, B3/B2 {others}")
    if not (np.isfinite(epoch["loss"]) and result["accuracy"] > 0.9):
        raise AssertionError(f"phase 24: loss {epoch['loss']}, accuracy {result['accuracy']}")
    kernels["normalize_u8"]["launches"] += launches
    # the step alone on one resident batch, and its device time: what the
    # epoch's step costs without the feed
    step = mnist.make_step("cuda")
    image = torch.randint(0, 256, (MNIST_BATCH, 28, 28), dtype=torch.uint8, device="cuda",
                          generator=gen)
    digit = torch.randint(0, 10, (MNIST_BATCH,), device="cuda", generator=gen)
    for _ in range(20):
        step(image, digit)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MNIST_RESIDENT_STEPS):
        step(image, digit)
    torch.cuda.synchronize()
    resident_ms = 1e3 * (time.perf_counter() - t0) / MNIST_RESIDENT_STEPS
    device_ms, by_op = device_time_by_op(step, image, digit, steps=20, top=8)

    hello = os.path.join(tmp, "hello_world")
    with contextlib.redirect_stdout(io.StringIO()):
        hello_generate.generate_hello_world_dataset(hello, rows_count=10)
        rows = hello_read.python_hello_world(hello)
        columns = hello_read.columnar_hello_world(hello)
        fed = hello_read.cuda_hello_world(hello, device="cuda")
    with make_reader(hello, reader_pool_type="serial", schema_fields=["id", "image1"]) as reader:
        images = {int(r.id): r.image1 for r in reader}
    fed_ids = []
    for batch in fed:
        valid = int(batch.get(VALID_ROWS, 4))
        if batch["image1"].device.type != "cuda" or batch["image1"].dtype != torch.uint8:
            raise AssertionError(f"phase 24: hello-world image1 on {batch['image1'].device}")
        for i, img in zip(batch["id"][:valid].tolist(), batch["image1"][:valid].cpu().numpy()):
            if not np.array_equal(img, images[i]):
                raise AssertionError(f"phase 24: hello-world row {i} differs on the card")
            fed_ids.append(i)
    if not (sorted(r[0] for r in rows) == sorted(sum(columns, [])) == sorted(fed_ids)
            == list(range(10))):
        raise AssertionError(f"phase 24: hello-world ids {rows}, {columns}, {fed_ids}")

    pre_url = os.path.join(tmp, "preemption")
    preemption.generate_dataset(pre_url, rows=PREEMPT_ROWS)
    seen = []
    t0 = time.perf_counter()
    seen_a, seen_b, loss = preemption.train(pre_url, device="cuda", verbose=False,
                                            ckpt_dir=os.path.join(tmp, "preemption_ckpt"),
                                            on_rows=seen.append)
    preempt_s = time.perf_counter() - t0
    with make_reader(pre_url, reader_pool_type="serial", schema_fields=["x"]) as reader:
        written = sorted(r.x.tobytes() for r in reader)
    if (seen_a + seen_b != PREEMPT_ROWS or not seen_a or not seen_b or not np.isfinite(loss)
            or sorted(row.tobytes() for rows_ in seen for row in rows_) != written):
        raise AssertionError(f"phase 24: the preemption example trained {seen_a} + {seen_b}"
                             f" rows, not each of {PREEMPT_ROWS} once")
    phase("mnist_train", normalize_c1=b1, rows=MNIST_ROWS, batch=MNIST_BATCH,
          write_s=write_s, steps=epoch["steps"], epoch_s=epoch["seconds"],
          samples_per_s=epoch["samples_per_s"],
          step_ms=1e3 * epoch["seconds"] / (epoch["steps"] - 1),
          consumer_wait_share=epoch["consumer_wait_share"], loss=epoch["loss"],
          resident_step_ms=resident_ms, resident_device_ms_per_step=device_ms,
          resident_device_busy_share=device_ms / resident_ms,
          resident_device_ms_by_op=by_op,
          accuracy=result["accuracy"], normalize_launches=launches, normalize_plain_calls=0,
          hello_world_rows=len(rows), hello_world_batches=len(fed),
          preemption_rows=[seen_a, seen_b], preemption_loss=loss, preemption_s=preempt_s,
          every_row_once=True)

def attention_pairs(sq, sk, causal, q_offset, k_offset):
    """The (query, key) pairs a block attends: all of them, or under
    ``causal`` those with ``k_offset + j <= q_offset + i``."""
    if not causal:
        return sq * sk
    return int(np.clip(q_offset + np.arange(sq) - k_offset + 1, 0, sk).sum())


def b4_bound(b, h, sq, sk, d, pairs, backward):
    """The bounds of one B4 launch: its bytes (each input read once, each
    output written once, float32) over 3.35 TB/s, and the flops of the pairs
    it attends (two products forward, five backward) over 67 TFLOP/s float32
    SIMT and over 165 TFLOP/s, 495 TFLOP/s of TF32 tensor cores at three
    TF32 products a float32 one (3xTF32).  Returns the ms of each and the
    table's (bound ms, bound_by): the larger of bytes and 3xTF32, the least
    time the card can take for float32-accurate products."""
    bh = b * h
    if backward:  # q, dout, k, v, lse, delta and dq, dk, dv read; dq, dk, dv written
        nbytes = 4 * bh * (2 * sq * d + 2 * sk * d + 2 * sq + 2 * (sq * d + 2 * sk * d))
        flops = 10 * bh * d * pairs
    else:  # q, k, v and the running o, l, m read; o, l, m written
        nbytes = 4 * bh * (sq * d + 2 * sk * d + 2 * (sq * d + 2 * sq))
        flops = 4 * bh * d * pairs
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_simt, t_tf32 = 1e3 * flops / F32_FLOPS_PER_S, 1e3 * flops / F32_3XTF32_FLOPS_PER_S
    return {"bytes_ms": t_bytes, "simt_ops_ms": t_simt, "tf32x3_ops_ms": t_tf32,
            "bound_ms": max(t_bytes, t_tf32),
            "bound_by": "bytes" if t_bytes > t_tf32 else "operations"}


def b4_max_err(got, want, rel, what):
    """Max |got - want| over the finite values, checked against ``rel`` of the
    largest |want|; the infinities in the same places."""
    if not torch.equal(torch.isinf(got), torch.isinf(want)):
        raise AssertionError(f"{what}: -inf rows differ from the plain version")
    finite = torch.isfinite(want)
    err = (got[finite] - want[finite]).abs().max().item()
    scale = want[finite].abs().max().item()
    if not err <= rel * scale:
        raise AssertionError(f"{what}: max err {err} above {rel} x {scale}")
    return err


def b4_compiler_facts():
    """ptxas's registers, stack and spills and the SASS HMMA (tensor-core
    product) count of each kernel in ``csrc/block_attention.cu``, by its
    unmangled name (the D <= 64 and D <= 128 instances as ``<8>``, ``<16>``)."""
    import re

    hmma = build.sass_instruction_counts("block_attention", "HMMA")
    facts = {}
    for mangled, report in build.ptxas_report("block_attention").items():
        m = re.search(r"\d+(block_attention_\w+?_kernel|attention_row_delta_kernel)"
                      r"(?:ILi(\d+)EE)?", mangled)
        name = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
        facts[name] = {**report, "hmma": hmma.get(mangled)}
    for name in ("block_attention_fwd_kernel", "block_attention_dkdv_kernel",
                 "block_attention_dq_kernel"):
        for inst in ("<8>", "<16>"):
            if hmma and not facts[name + inst]["hmma"]:
                raise AssertionError(f"B4's {name}{inst} has no HMMA in its SASS")
    return facts


def block_attention_entry():
    """Phase 3, B4: forward and backward against their plain versions on
    three blocks of the trainer's ring, timed beside their bounds, the SIMT
    kernels in turns, the plain versions and SDPA (float32)."""
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    b, h, s, d = B4_SHAPE
    scale = 1.0 / d ** 0.5
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v, dout = (torch.randn(B4_SHAPE, device="cuda", generator=gen) for _ in range(4))
    cases = {"diagonal": (True, s, s), "off_diagonal": (False, s, 0),
             "masked_rows": (True, 0, s // 2)}  # rows 0..S/2-1 see none of its keys
    results = {}
    delta_errs = []
    for name, (causal, q_off, k_off) in cases.items():
        pairs = attention_pairs(s, s, causal, q_off, k_off)
        state = [torch.zeros_like(q), torch.zeros(b, h, s, device="cuda"),
                 torch.full((b, h, s), -torch.inf, device="cuda")]
        plain = [t.clone() for t in state]
        simt = [t.clone() for t in state]
        ring_ops.block_attention_fwd(q, k, v, *state, scale, causal, q_off, k_off)
        ring_ops.block_attention_fwd_reference(q, k, v, *plain, scale, causal, q_off, k_off)
        ring_ops.block_attention_fwd_simt(q, k, v, *simt, scale, causal, q_off, k_off)
        torch.cuda.synchronize()
        for got, want, what in zip(state + simt, plain + plain, ("o", "l", "m") * 2):
            b4_max_err(got, want, 1e-5, f"B4 fwd {name} {what}")
        out, lse = ring_ops._finish(*state)
        want_out, _ = ring_ops._finish(*plain)
        fwd_err = b4_max_err(out, want_out, 1e-5, f"B4 fwd {name} out")
        delta = ring_ops.attention_row_delta(out, dout)
        delta_errs.append(b4_max_err(delta, ring_ops.attention_row_delta_reference(out, dout),
                                     1e-5, f"B4 delta {name}"))
        grads = [torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)]
        plain_grads = [torch.zeros_like(t) for t in grads]
        simt_grads = [torch.zeros_like(t) for t in grads]
        ring_ops.block_attention_bwd(q, k, v, dout, lse, delta, *grads, scale, causal, q_off,
                                     k_off)
        ring_ops.block_attention_bwd_reference(q, k, v, dout, lse, delta, *plain_grads, scale,
                                               causal, q_off, k_off)
        ring_ops.block_attention_bwd_simt(q, k, v, dout, lse, delta, *simt_grads, scale,
                                          causal, q_off, k_off)
        torch.cuda.synchronize()
        bwd_err = max(b4_max_err(g, w, 1e-4, f"B4 bwd {name} d{n}")
                      for g, w, n in zip(grads, plain_grads, "qkv"))
        for g, w, n in zip(simt_grads, plain_grads, "qkv"):
            b4_max_err(g, w, 1e-4, f"B4 SIMT bwd {name} d{n}")
        o, l, m = (torch.zeros_like(q), torch.zeros(b, h, s, device="cuda"),
                   torch.full((b, h, s), -torch.inf, device="cuda"))
        timing = dict(samples=5, launches=3, warmup=1)

        def in_turns(kernel, yardstick):
            """Median times of ``kernel`` and ``yardstick`` timed kernel,
            yardstick, yardstick, kernel: each the mean of its two turns."""
            t = [time_ms(fn, **timing) for fn in (kernel, yardstick, yardstick, kernel)]
            return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t

        fwd_ms, fwd_simt_ms, fwd_turns = in_turns(
            lambda: ring_ops.block_attention_fwd(q, k, v, o, l, m, scale, causal, q_off, k_off),
            lambda: ring_ops.block_attention_fwd_simt(q, k, v, o, l, m, scale, causal, q_off,
                                                      k_off))
        fwd_plain_ms = time_ms(lambda: ring_ops.block_attention_fwd_reference(
            q, k, v, o, l, m, scale, causal, q_off, k_off), **timing)
        bwd_ms, bwd_simt_ms, bwd_turns = in_turns(
            lambda: ring_ops.block_attention_bwd(q, k, v, dout, lse, delta, *grads, scale,
                                                 causal, q_off, k_off),
            lambda: ring_ops.block_attention_bwd_simt(q, k, v, dout, lse, delta, *grads, scale,
                                                      causal, q_off, k_off))
        bwd_plain_ms = time_ms(lambda: ring_ops.block_attention_bwd_reference(
            q, k, v, dout, lse, delta, *grads, scale, causal, q_off, k_off), **timing)
        delta_ms = time_ms(lambda: ring_ops.attention_row_delta(out, dout), **timing)
        delta_plain_ms = time_ms(lambda: ring_ops.attention_row_delta_reference(out, dout),
                                 **timing)
        delta_library_ms = time_ms(lambda: torch.linalg.vecdot(out, dout), **timing)
        sdpa_fwd_ms = sdpa_bwd_ms = None
        if name != "masked_rows":  # SDPA has no offset mask, and NaNs an empty row
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            sdpa_fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(
                *leaves, is_causal=causal), **timing)
            sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
            sdpa_bwd_ms = time_ms(lambda: torch.autograd.grad(sdpa_out, leaves, dout,
                                                              retain_graph=True), **timing)
            del sdpa_out, leaves
        fwd_bound = b4_bound(b, h, s, s, d, pairs, False)
        bwd_bound = b4_bound(b, h, s, s, d, pairs, True)
        results[name] = {
            "causal": causal, "q_offset": q_off, "k_offset": k_off, "pairs": pairs,
            "fwd": {"max_abs_err": fwd_err, "ms": fwd_ms, "simt_ms": fwd_simt_ms,
                    "turns_ms": fwd_turns, "plain_ms": fwd_plain_ms, "sdpa_ms": sdpa_fwd_ms,
                    **fwd_bound, "tflops": 4 * b * h * d * pairs / fwd_ms / 1e9},
            "bwd": {"max_abs_err": bwd_err, "ms": bwd_ms, "simt_ms": bwd_simt_ms,
                    "turns_ms": bwd_turns, "plain_ms": bwd_plain_ms, "sdpa_ms": sdpa_bwd_ms,
                    **bwd_bound, "tflops": 10 * b * h * d * pairs / bwd_ms / 1e9},
            "delta": {"ms": delta_ms, "plain_ms": delta_plain_ms,
                      "library_ms": delta_library_ms}}
        del state, plain, simt, grads, plain_grads, simt_grads
        torch.cuda.empty_cache()
    phase("kernels", block_attention={"shape": list(B4_SHAPE), "dtype": "float32",
                                      "cases": results, "compiler": b4_compiler_facts()})
    diag = results["diagonal"]
    source = "petastorm_tpu_torch/csrc/block_attention.cu"
    entries = {}
    for key, function in (("fwd", "block_attention_fwd_kernel<16>"),
                          ("bwd", "block_attention_dkdv_kernel<16> + "
                                  "block_attention_dq_kernel<16>")):
        r = diag[key]
        entries[f"block_attention_{key}"] = {
            "name": f"block_attention_{key}", "route": "cuda", "source": source,
            "function": function, "replaces": "petastorm_tpu/ops/ring_attention.py:40",
            "max_abs_err": max(results[c][key]["max_abs_err"] for c in results),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["sdpa_ms"], "simt_ms": r["simt_ms"],
            "launches": 0}
    # the backward's row delta, rowsum(dout * out): out and dout read, delta
    # written, 2 flops an element, so bytes bound it
    r = diag["delta"]
    t_bytes = 4 * b * h * s * (2 * d + 1) / HBM_BYTES_PER_S
    t_ops = 2 * b * h * s * d / F32_FLOPS_PER_S
    entries["attention_row_delta"] = {
        "name": "attention_row_delta", "route": "cuda", "source": source,
        "function": "attention_row_delta_kernel",
        "replaces": "petastorm_tpu/ops/ring_attention.py:40",
        "max_abs_err": max(delta_errs), "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes > t_ops else "operations",
        "library_ms": r["library_ms"], "launches": 0}
    return entries


def packed_block_digest(columns):
    """``packed_stream_digest`` of the rows of ``columns`` as one block, so
    that two deliveries of the same rows in other batchings agree."""
    return packed_stream_digest([{name: np.asarray(col) for name, col in columns.items()}])


def packed_mesh_rank(args):
    """One rank of phase 25's packed loader on a mesh (``python3
    chip_smoke.py --packed-mesh-rank JSON``, started by ``launch.run_ranks``):
    its blocks of every batch on the card, to exhaustion, and their digest."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="env://")
    try:
        rank = dist.get_rank()
        mesh = init_device_mesh("cpu", (dist.get_world_size(),), mesh_dim_names=("data",))
        fields = ("tokens", "segment_ids", "positions", "loss_mask")
        rows = {name: [] for name in fields}
        devices = set()
        with make_packed_sequence_loader(args["url"], PACKED_BATCH, PACKED_SEQ,
                                         seed=PACKED_SEED, long_docs="split", device="cuda",
                                         loader_kwargs={"mesh": mesh, "drop_last": False,
                                                        "shardings": {f: (Shard(0),)
                                                                      for f in fields}}
                                         ) as loader:
            for batch in loader:
                valid = int(batch.get(VALID_ROWS, PACKED_BATCH // dist.get_world_size()))
                for name in fields:
                    devices.add(str(batch[name].device))
                    rows[name].append(batch[name][:valid].cpu().numpy())
        columns = {name: np.concatenate(v) for name, v in rows.items()}
        with open(f"{args['out']}.{rank}.json", "w") as f:
            json.dump({"rank": rank, "rows": int(len(columns["tokens"])),
                       "real_tokens": int(np.count_nonzero(columns["loss_mask"])),
                       "digest": f"{packed_block_digest(columns):08x}",
                       "devices": sorted(devices)}, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def packed_mesh_check(tmp):
    """Phase 25's packed token loader over a 2-rank mesh on ``cuda:0``: each
    rank's delivered rows against the CPU packing of its shard."""
    url = os.path.join(tmp, "tokens_1")  # phase 23's second corpus
    prefix = os.path.join(tmp, "packed_mesh")
    cmd = [sys.executable, os.path.abspath(__file__), "--packed-mesh-rank",
           json.dumps({"url": url, "out": prefix})]
    t0 = time.perf_counter()
    error = launch.run_ranks(cmd, CP_RANKS, CHILD_TIMEOUT_S, prefix)
    if error:
        raise AssertionError(f"phase 25, the packed loader on a mesh: {error}")
    wall = time.perf_counter() - t0
    ranks = []
    for rank in range(CP_RANKS):
        with open(f"{prefix}.{rank}.json") as f:
            got = json.load(f)
        columns = {}
        with PackedSequenceReader(make_sequence_reader(url, shuffle_seed=PACKED_SEED,
                                                       cur_shard=rank, shard_count=CP_RANKS),
                                  PACKED_SEQ, rows_per_batch=PACKED_BATCH,
                                  long_docs="split") as packed:
            for block in packed.iter_batches():
                for name, col in block.columns.items():
                    columns.setdefault(name, []).append(col)
        want = packed_block_digest({k: np.concatenate(v) for k, v in columns.items()})
        if got["digest"] != f"{want:08x}" or got["devices"] != ["cuda:0"] or not got["rows"]:
            raise AssertionError(f"phase 25: rank {rank} delivered {got}, the CPU packing of"
                                 f" its shard has digest {want:08x}")
        ranks.append(got)
    return {"ranks": ranks, "seq_len": PACKED_SEQ, "global_batch": PACKED_BATCH,
            "digests_match_cpu_packing": True, "wall_s": wall}


def selfcheck_phase(tmp, kernels):
    """Phase 25: the port's six multi-process checks, their ranks on cuda:0
    over gloo, and the packed token loader over a 2-rank mesh.  The first
    three run one after the other (the pipeline check's unequal drain rests
    on timing); the other three and the packed loader run at once."""
    out = {}

    def run(name, fn, kwargs):
        t0 = time.perf_counter()
        report = fn(device="cuda", timeout=CHILD_TIMEOUT_S,
                    workdir=os.path.join(tmp, f"selfcheck_{name}"),
                    **dict({"num_processes": CP_RANKS}, **kwargs))
        if not report["ok"]:
            raise AssertionError(f"selfcheck {name} failed: {report['failures']}")
        out[name] = {k: v for k, v in report.items()
                     if k not in ("logs", "workdir", "failures", "ok")}
        out[name]["seconds"] = time.perf_counter() - t0

    for name, fn in (("pipeline", selfcheck.run_selfcheck),
                     ("write", selfcheck.run_distributed_write_check),
                     ("context_parallel", selfcheck.run_context_parallel_check)):
        run(name, fn, {})
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=4) as pool:
        jobs = [pool.submit(run, "shuffled", selfcheck.run_shuffled_check,
                            {"num_processes": SHUFFLE_RANKS}),
                pool.submit(run, "mixed", selfcheck.run_mixed_check, {}),
                pool.submit(run, "mesh2d", selfcheck.run_mesh2d_check,
                            {"num_processes": MESH2D_SHAPE[0],
                             "devices_per_process": MESH2D_SHAPE[1]})]
        packed = pool.submit(packed_mesh_check, tmp)
        for job in jobs:
            job.result()
        out["packed_mesh"] = packed.result()
    out["concurrent_wall_s"] = time.perf_counter() - t0
    for name in ("pipeline", "context_parallel", "shuffled", "mixed", "mesh2d"):
        if out[name]["devices"] != ["cuda:0"]:
            raise AssertionError(f"selfcheck {name} delivered off the card: {out[name]}")
    if min(out["mixed"]["b2_launches"]) < 1:
        raise AssertionError(f"the mixed check's ranks launched B2 {out['mixed']['b2_launches']}"
                             " times")
    kernels["jpeg_decode_u8"]["launches"] += sum(out["mixed"]["b2_launches"])
    phase("selfcheck", ranks=CP_RANKS, backend=out["context_parallel"]["backend"],
          transport=out["context_parallel"]["transport"], **out)


def long_context_phase(tmp, kernels):
    """Phase 26: the long-context trainer, ring then Ulysses, two ranks on the
    seq dimension of cuda:0; B4's launches summed over the ranks."""
    url = os.path.join(tmp, "longctx")
    t0 = time.perf_counter()
    longctx.generate_dataset(url, LC_ROWS, LC_SEQ, LC_VOCAB)
    write_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    runs = {}
    for strategy in ("ring", "ulysses"):
        prefix = os.path.join(tmp, f"longctx_{strategy}")
        cmd = [sys.executable, "-m",
               "petastorm_tpu_torch.examples.long_context.train_ring_attention_cuda",
               "--dataset", url, "--seq-len", str(LC_SEQ), "--vocab", str(LC_VOCAB),
               "--heads", str(LC_HEADS), "--head-dim", str(LC_HEAD_DIM),
               "--global-batch", str(LC_BATCH), "--steps", str(LC_WARMUP + LC_TIMED),
               "--warmup", str(LC_WARMUP), "--data-par", "1", "--strategy", strategy,
               "--device", "cuda", "--check-plain", "--report", prefix]
        t0 = time.perf_counter()
        error = launch.run_ranks(cmd, CP_RANKS, CHILD_TIMEOUT_S, prefix)
        if error:
            raise AssertionError(error)
        wall = time.perf_counter() - t0
        reports = []
        for rank in range(CP_RANKS):
            with open(f"{prefix}.{rank}.json") as f:
                reports.append(json.load(f))
        for rank, r in enumerate(reports):
            first = r["first_step"]
            if not all(np.isfinite(r["losses"])):
                raise AssertionError(f"{strategy} rank {rank}: losses {r['losses']}")
            # the loss sits at ln(vocab) at this init whatever the attention
            # gives: the attention output and the gradients decide
            if (first["loss_rel_err"] > 1e-5 or first["attention_rel_err"] > 1e-5
                    or max(first["grad_rel_err"].values()) > 1e-4):
                raise AssertionError(f"{strategy} rank {rank}: the first step is off its"
                                     f" plain version: {first}")
            if min(r["launches"].values()) < 1 or r["plain_cuda_calls"]:
                raise AssertionError(f"{strategy} rank {rank}: B4 launches {r['launches']},"
                                     f" plain calls {r['plain_cuda_calls']}")
            if r["losses"] != reports[0]["losses"]:
                raise AssertionError(f"{strategy}: ranks report different losses")
        for name in ("block_attention_fwd", "block_attention_bwd", "attention_row_delta"):
            kernels[name]["launches"] += sum(r["launches"][name] for r in reports)
        runs[strategy] = {
            "backend": reports[0]["backend"], "transport": reports[0]["transport"],
            "mesh": reports[0]["mesh"], "losses": reports[0]["losses"],
            "tokens_per_s": reports[0]["tokens_per_s"],
            "step_ms": max(r["step_ms"] for r in reports),
            "allreduce_ms": [r["allreduce_ms"] for r in reports],
            "consumer_wait_share": max(r["consumer_wait_share"] for r in reports),
            "peak_memory_bytes": [r["peak_memory_bytes"] for r in reports],
            "launches": [r["launches"] for r in reports], "plain_attention_calls": 0,
            "first_step": reports[0]["first_step"],
            "plain_cuda_calls_in_check": [r["plain_cuda_calls_in_check"] for r in reports],
            "wall_s": wall}
    phase("long_context_train", heads=LC_HEADS, head_dim=LC_HEAD_DIM, vocab=LC_VOCAB,
          seq_len=LC_SEQ, global_batch=LC_BATCH, ranks=CP_RANKS, warmup_steps=LC_WARMUP,
          timed_steps=LC_TIMED, write_s=write_s, **runs)


def data_parallel_phase(tmp, path, kernels):
    """Phase 27: the data-parallel flagship trainer, two ranks sharing cuda:0
    over gloo, on phase 6's dataset with device decode; the ranks' leaves
    equal bit for bit, and the first step recomputed here from the gathered
    global batch and draws."""
    prefix = os.path.join(tmp, "dp")
    first_path = prefix + ".first.pt"
    cores = os.cpu_count() or 2
    workers = max(1, min((cores - 1) // DP_RANKS, 8))
    cmd = [sys.executable, "-m", "petastorm_tpu_torch.examples.imagenet.train_resnet_cuda",
           "--dataset-url", path, "--skip-generate", "--side", str(SIDE),
           "--global-batch", str(DP_BATCH), "--warmup", str(DP_WARMUP),
           "--steps", str(DP_TIMED), "--workers", str(workers), "--decode", "device",
           "--device", "cuda", "--report", prefix, "--first-step", first_path]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    error = launch.run_ranks(cmd, DP_RANKS, CHILD_TIMEOUT_S, prefix)
    if error:
        raise AssertionError(f"phase 27: {error}")
    wall = time.perf_counter() - t0
    reports = []
    for rank in range(DP_RANKS):
        with open(f"{prefix}.{rank}.json") as f:
            reports.append(json.load(f))
    digests = {r["params_digest"] for r in reports}
    if len(digests) != 1:
        raise AssertionError(f"phase 27: the ranks' leaves differ: digests {digests}")
    for rank, r in enumerate(reports):
        if r["world_size"] != DP_RANKS or not np.isfinite(r["final_loss"]):
            raise AssertionError(f"phase 27: rank {rank} reported {r}")
        # B1 and B3 once a step in every rank: warm-up, timed and the compute
        # floor's rerun on one resident batch; B2 once a batch the loader
        # staged: every batch stepped on, and those it prefetched
        steps = DP_WARMUP + 2 * DP_TIMED
        got = r["launches"]
        if (got["normalize_u8"] != steps or got["resized_crop_flip_u8"] != steps
                or got["jpeg_decode_u8"] < DP_WARMUP + DP_TIMED + 1):
            raise AssertionError(f"phase 27: rank {rank} launched {got} in {steps} steps over"
                                 f" {DP_WARMUP + DP_TIMED + 1} batches")
    for name in ("normalize_u8", "resized_crop_flip_u8", "jpeg_decode_u8"):
        kernels[name]["launches"] += sum(r["launches"][name] for r in reports)
    recompute = recompute_first_step(first_path)
    phase("data_parallel_train", ranks=DP_RANKS, global_batch=DP_BATCH,
          rank_batch=DP_BATCH // DP_RANKS, warmup_steps=DP_WARMUP, timed_steps=DP_TIMED,
          decode="device", backend="gloo", transport=reports[0]["transport"],
          samples_per_s=[r["samples_per_sec"] for r in reports],
          samples_per_s_per_gpu=[r["samples_per_sec_per_gpu"] for r in reports],
          allreduce_ms=[r["allreduce_ms"] for r in reports],
          step_ms=[1e3 * r["wall_s"] / r["steps"] for r in reports],
          consumer_wait_pct=[r["device_idle_pct"] for r in reports],
          final_loss=reports[0]["final_loss"], params_digest=reports[0]["params_digest"],
          ranks_leaves_identical=True, launches=[r["launches"] for r in reports],
          first_step_recomputed=recompute, wall_s=wall)


def recompute_first_step(first_path):
    """The first data-parallel step again in this process, from the seed-0
    weights and the gathered global batch and draws: as gradient
    accumulation over the ranks' blocks (the data-parallel step's own
    arithmetic: each block's bf16 gradients, averaged in float32), held to
    ``tests/test_torch_train.py``'s bound, 1e-6 * max|leaf| a leaf; and as
    one pass over the global batch, whose bf16 gradients round once, held to
    phase 5's bound on the update (relative error 0.03)."""
    record = torch.load(first_path)
    images, labels = record["images"].cuda(), record["labels"].cuda()
    boxes, flips = record["boxes"].cuda(), record["flips"].cuda()
    ranks_after = [leaf.cuda() for leaf in record["leaves"]]
    out = {}
    for mode in ("blocks", "global"):
        model = ResNet50(num_classes=1000, dtype=torch.bfloat16, device="cuda",
                         generator=torch.Generator().manual_seed(0))
        model = model.to(memory_format=torch.channels_last)
        step = trainer.TrainStep(model, 1000, SIDE)
        before = [leaf.detach().clone() for leaf in step.leaves]
        if mode == "global":
            loss = float(step(images, labels, boxes=boxes, flips=flips))
        else:
            n = DP_BATCH // DP_RANKS
            step.optimizer.zero_grad(set_to_none=True)
            losses = []
            for r in range(DP_RANKS):
                rows = slice(r * n, (r + 1) * n)
                crops = augment.random_resized_crop(images[rows], None, (SIDE, SIDE),
                                                    boxes=boxes[rows], flips=flips[rows])
                block_loss = trainer.softmax_cross_entropy(
                    model(normalize.normalize_images(crops)), labels[rows], 1000)
                (block_loss / DP_RANKS).backward()
                losses.append(block_loss.detach())
            step.optimizer.step()
            loss = float(torch.stack(losses).mean())
        leaf_err = max(float((a - b.detach()).abs().max() / b.detach().abs().max())
                       for a, b in zip(ranks_after, step.leaves))
        upd_ranks = torch.cat([(a - b).flatten() for a, b in zip(ranks_after, before)])
        upd_here = torch.cat([(a.detach() - b).flatten() for a, b in zip(step.leaves, before)])
        out[mode] = {"loss": loss, "loss_ranks": record["loss"],
                     "max_leaf_err_over_max_leaf": leaf_err,
                     "update_rel_err": float((upd_ranks - upd_here).norm() / upd_here.norm())}
        del model, step, before
        torch.cuda.empty_cache()
    if out["blocks"]["max_leaf_err_over_max_leaf"] > 1e-6:
        raise AssertionError(f"phase 27: the ranks' first step is off its one-process"
                             f" recomputation over the same blocks: {out}")
    if out["global"]["update_rel_err"] > 0.03 or abs(out["global"]["loss"] - record["loss"]) > 1e-3:
        raise AssertionError(f"phase 27: the ranks' first step is off the one-pass step over"
                             f" the global batch: {out}")
    out["bounds"] = {"blocks_max_leaf_err_over_max_leaf": 1e-6, "global_update_rel_err": 0.03,
                     "global_loss_abs": 1e-3}
    return out


def remote_read_phase(tmp, path, kernels, device):
    """Phase 28: phase 6's device-decode training read through the
    latency-injecting filesystem with ``io_retries='auto'``: the labels and
    the first batch's pixels equal phase 6's, the retries counted, one ranged
    read a rowgroup; then a store that always fails opens the circuit."""
    fs, stats = latent_filesystem(latency_s=REMOTE_LATENCY_S, fail_first_reads=REMOTE_FAIL_READS,
                                  fail_first_opens=REMOTE_FAIL_OPENS)
    cores = os.cpu_count() or 2
    workers = max(1, min(cores - 1, 16))
    reader = make_reader(path, workers_count=workers, shuffle_seed=0, num_epochs=1,
                         decode_placement={"image": "device"}, filesystem=fs,
                         io_retries="auto")
    run = train_epoch(path, "device", source=(reader, [reader]))
    io_stats = reader.io_stats()
    for name in ("normalize_u8", "resized_crop_flip_u8", "jpeg_decode_u8"):
        kernels[name]["launches"] += run["launches"][name]
    if not torch.equal(run["labels"], device["labels"]):
        raise AssertionError("phase 28: the remote read delivered other labels, or in another"
                             " order, than phase 6's local read")
    if not torch.equal(run["first"][0].cpu(), device["first_images"]):
        raise AssertionError("phase 28: the first batch's pixels differ from phase 6's")
    injected = stats.snapshot()
    # the _common_metadata probe takes one failure without a retry (the JAX
    # package's rule); every other failure is retried
    if (injected["failures_injected"] != REMOTE_FAIL_READS + REMOTE_FAIL_OPENS
            or io_stats["retries"] != REMOTE_FAIL_READS + REMOTE_FAIL_OPENS - 1
            or io_stats["reads_per_rowgroup"] != 1.0):
        raise AssertionError(f"phase 28: injected {injected}, the reader counted {io_stats}")
    # a store that fails every request once the dataset is open
    dead_fs, dead_stats = latent_filesystem(latency_s=REMOTE_LATENCY_S)
    dead = make_reader(path, workers_count=workers, shuffle_seed=0, num_epochs=1,
                       decode_placement={"image": "device"}, filesystem=dead_fs,
                       io_retries="auto")
    dead_fs.handler._fail_reads[0] = dead_fs.handler._fail_opens[0] = 10 ** 9
    t0 = time.perf_counter()
    raised = None
    try:
        with CudaDataLoader(dead, batch_size=BATCH, device="cuda") as loader:
            for _ in loader:
                pass
    except Exception as exc:  # noqa: BLE001 - inspected below
        raised = exc
    circuit_s = time.perf_counter() - t0
    chain, exc = [], raised
    while exc is not None:
        chain.append(exc)
        exc = exc.__cause__ or exc.__context__
    if not any(isinstance(e, CircuitOpenError) for e in chain) or circuit_s > CIRCUIT_BOUND_S:
        raise AssertionError(f"phase 28: a dead store raised {chain!r} after {circuit_s:.2f} s;"
                             f" expected CircuitOpenError within {CIRCUIT_BOUND_S} s")
    steps, timed = run["steps"], run["timed"]
    phase("remote_read_train_device_decode", latency_ms=1e3 * REMOTE_LATENCY_S,
          fail_first_reads=REMOTE_FAIL_READS, fail_first_opens=REMOTE_FAIL_OPENS,
          io_retries="auto", workers=workers, steps=steps, batch=BATCH,
          samples_per_s=run["samples_per_s"], local_samples_per_s=device["samples_per_s"],
          consumer_wait_share=run["wait"] / timed, io_stats=io_stats, fake_stats=injected,
          labels_match_local=True, first_batch_pixels_match_local=True,
          launches=run["launches"], circuit_breaker=dead.circuit_breaker.snapshot(),
          dead_store_raised=type(raised).__name__, dead_store_seconds=circuit_s,
          dead_store_bound_s=CIRCUIT_BOUND_S, dead_store_requests_failed=(
              dead_stats.snapshot()["failures_injected"]))


def same_epoch(run, want, what):
    """``run`` delivered ``want``'s labels in its order and every batch's
    image sum equal; a failure names ``what``."""
    if not torch.equal(run["labels"], want["labels"]):
        raise AssertionError(f"{what}: other labels, or in another order, than the clean run")
    if not torch.equal(run["image_sums"], want["image_sums"]):
        bad = (run["image_sums"] != want["image_sums"]).nonzero().flatten().tolist()
        raise AssertionError(f"{what}: the image sums of batches {bad} differ from the clean run")


def no_children(what):
    """No child process of this one is left (bounded wait for their exit)."""
    deadline = time.monotonic() + 10
    while multiprocessing.active_children() and time.monotonic() < deadline:
        time.sleep(0.1)
    left = multiprocessing.active_children()
    if left:
        raise AssertionError(f"{what}: child processes left after stop(): {left}")


def process_pool_phase(path, kernels, host, device):
    """Phase 29: phases 6 and 5 with ``reader_pool_type='process'``."""
    t0 = time.perf_counter()
    runs, out = {}, {}
    for decode, want, name in (("device", device, "phase 6"), ("host", host, "phase 5")):
        run = train_epoch(path, decode, reader_kwargs=dict(reader_pool_type="process"))
        no_children(f"phase 29, {decode} decode")
        same_epoch(run, want, f"phase 29, {decode} decode against {name}")
        for kernel in ("normalize_u8", "resized_crop_flip_u8", "jpeg_decode_u8"):
            kernels[kernel]["launches"] += run["launches"][kernel]
        stats = run["diagnostics"]["transport"]
        steps = run["steps"]
        if stats["shm_batches"] != N_ROWS // ROWS_PER_GROUP or stats["pickled_batches"]:
            raise AssertionError(f"phase 29, {decode} decode: {stats['shm_batches']} batches"
                                 f" through the arena and {stats['pickled_batches']} pickled;"
                                 f" expected {N_ROWS // ROWS_PER_GROUP} and 0")
        want_slots = N_ROWS if decode == "host" else 0
        if stats["slot_rows"] != want_slots:
            raise AssertionError(f"phase 29, {decode} decode: {stats['slot_rows']} images"
                                 f" decoded into arena slots, expected {want_slots}")
        runs[decode] = run
        out[decode] = {
            "samples_per_s": run["samples_per_s"], f"{name.replace(' ', '')}_samples_per_s":
            want["samples_per_s"], "relative": run["samples_per_s"] / want["samples_per_s"] - 1,
            "epoch_s": run["epoch_s"], "step_ms": 1e3 * run["timed"] / (steps - WARMUP_STEPS),
            "input_idle_share": run["wait"] / run["timed"], "launches": run["launches"],
            "shm_size_bytes": stats["shm_size_bytes"],
            "shm_high_water_bytes": stats["shm_high_water_bytes"],
            "shm_batches": stats["shm_batches"], "pickled_batches": stats["pickled_batches"],
            "slot_rows": stats["slot_rows"], "worker_spawn_s": stats["worker_spawn_s"],
            "worker_rss_bytes": stats["worker_rss_bytes"],
            "reader_liveness": {k: run["diagnostics"]["reader"][k]
                                for k in ("requeued_items", "hung_workers_killed")}}
    phase("process_pool_train", workers=runs["device"]["workers"], batch=BATCH,
          steps=runs["device"]["steps"], labels_and_image_sums_match=True, children_left=0,
          seconds=time.perf_counter() - t0, **out)
    return runs["device"]


def chaos_phase(path, kernels, clean, device):
    """Phase 30: liveness under chaos on phase 6's device route.  The time a
    run lost is its epoch's seconds less those of the same pool's clean
    epoch: phase 29's for the process pool (its first batch waits for the
    workers' spawn), phase 6's for the thread pool."""
    t0 = time.perf_counter()
    out = {}

    def chaotic(name, pool_type, spec, **kwargs):
        run = train_epoch(path, "device", reader_kwargs=dict(
            reader_pool_type=pool_type, chaos=spec, **kwargs))
        no_children(f"phase 30, {name}")
        same_epoch(run, clean, f"phase 30, {name}")
        for kernel in ("normalize_u8", "resized_crop_flip_u8", "jpeg_decode_u8"):
            kernels[kernel]["launches"] += run["launches"][kernel]
        diag = run["diagnostics"]["reader"]
        base = (clean if pool_type == "process" else device)["epoch_s"]
        out[name] = {"samples_per_s": run["samples_per_s"], "epoch_s": run["epoch_s"],
                     "clean_epoch_s": base, "lost_s": run["epoch_s"] - base,
                     "input_idle_share": run["wait"] / run["timed"],
                     **{k: diag[k] for k in ("requeued_items", "hung_workers_killed",
                                             "hung_workers_abandoned", "hedged_items",
                                             "hedge_wins")}}
        if pool_type == "process":
            stats = run["diagnostics"]["transport"]
            out[name].update(pickled_batches=stats["pickled_batches"],
                             worker_spawn_s=stats["worker_spawn_s"])
        return run, diag, out[name]

    # 1. the process pool: a hang past the deadline, and a worker killed
    run, diag, res = chaotic(
        "process_hang_and_kill", "process",
        ChaosSpec(hang_ordinals=(CHAOS_HANG,), kill_ordinals=(CHAOS_KILL,), hang_s=CHAOS_HANG_S),
        item_deadline_s=CHAOS_DEADLINE_S)
    respawn_s = max(s for s in res["worker_spawn_s"] if s is not None)
    res["lost_bound_s"] = CHAOS_DEADLINE_S + respawn_s
    if not (diag["hung_workers_killed"] == 1 and diag["requeued_items"] >= 2
            and res["pickled_batches"] == 0 and res["lost_s"] <= res["lost_bound_s"]):
        raise AssertionError(f"phase 30, process pool hang and kill: {res}")
    # 2. the thread pool: the same hang, its slot abandoned
    run, diag, res = chaotic("thread_hang", "thread",
                             ChaosSpec(hang_ordinals=(CHAOS_HANG,), hang_s=CHAOS_HANG_S),
                             item_deadline_s=CHAOS_DEADLINE_S)
    res["lost_bound_s"] = CHAOS_DEADLINE_S
    if not (diag["hung_workers_abandoned"] == 1 and diag["requeued_items"] == 1
            and res["lost_s"] <= res["lost_bound_s"]):
        raise AssertionError(f"phase 30, thread pool hang: {res}")
    # 3. a slow ordinal hedged onto an idle worker, delivered once
    run, diag, res = chaotic("process_slow_hedged", "process",
                             ChaosSpec(slow_ordinals=(CHAOS_SLOW,), slow_s=CHAOS_SLOW_S),
                             hedge_after_s=CHAOS_HEDGE_S)
    if diag["hedged_items"] < 1:
        raise AssertionError(f"phase 30, slow item: nothing hedged: {res}")
    # 4. every attempt hangs, no deadline: the stall watchdog aborts
    reader = make_reader(path, reader_pool_type="process", shuffle_seed=0, num_epochs=1,
                         workers_count=max(1, min((os.cpu_count() or 2) - 1, 16)),
                         decode_placement={"image": "device"},
                         chaos=ChaosSpec(hang_ordinals=(CHAOS_HANG,), hang_on_retry=True,
                                         hang_s=CHAOS_HANG_S),
                         stall_abort_s=CHAOS_STALL_S)
    loader = CudaDataLoader(reader, batch_size=BATCH, device="cuda")
    delivered, raised, last = 0, None, time.perf_counter()
    try:
        for _ in loader:
            delivered += 1
            last = time.perf_counter()
    except PipelineStallError as exc:
        raised = exc
    finally:
        loader.stop()
    abort_s = time.perf_counter() - last
    threads_alive = [t.name for t in (loader._thread, loader._transfer_thread) if t.is_alive()]
    no_children("phase 30, stall abort")
    busy = [b[1] for b in raised.diagnostics.get("workers_busy", [])] if raised else []
    out["stall_abort"] = {"raised": type(raised).__name__, "batches_before": delivered,
                          "abort_s_after_last_batch": abort_s,
                          "bound_s": CHAOS_STALL_S + 5, "stuck_ordinals": busy,
                          "loader_threads_alive": threads_alive, "children_left": 0}
    if (raised is None or delivered != CHAOS_HANG or abort_s > CHAOS_STALL_S + 5
            or CHAOS_HANG not in busy or threads_alive):
        raise AssertionError(f"phase 30, stall abort: {out['stall_abort']}")
    phase("chaos_liveness", deadline_s=CHAOS_DEADLINE_S, hedge_after_s=CHAOS_HEDGE_S,
          slow_s=CHAOS_SLOW_S, stall_abort_s=CHAOS_STALL_S,
          ordinals={"hang": CHAOS_HANG, "kill": CHAOS_KILL, "slow": CHAOS_SLOW},
          labels_and_image_sums_match=True, seconds=time.perf_counter() - t0, **out)



SPLIT_AFTER_STEP = 8                              # phase 31: set_decode_split('host') after it
SHARED_TIER_BYTES = 1 << 30                       # phase 31: the warm tier's arena
TRACE_STEPS = 2                                   # phase 31: training steps in the trace


def observability_phase(tmp, path, kernels, host, device, warm):
    """Phase 31: observability and self-tuning on the main path, phase 6's
    training step at full width with B2, B3 and B1 counted in each part."""
    t0 = time.perf_counter()
    workers = max(1, min((os.cpu_count() or 2) - 1, 16))
    out = {"telemetry": telemetry_part(tmp, path, kernels, device, workers),
           "live_split": live_split_part(tmp, path, kernels, host, device),
           "shared_tier": shared_tier_part(tmp, path, kernels, device, warm, workers)}
    phase("observability_and_self_tuning", batch=BATCH, seconds=time.perf_counter() - t0,
          **out)


def telemetry_part(tmp, path, kernels, device, workers):
    """(a) One epoch of phase 6 with a recorder, the metrics endpoint, the
    flight recorder and the sampler on: phase 6's labels and image sums, a
    scrape in the epoch showing the stage and queue series, a dominant
    stage, the recorder's cost beside phase 6's samples/s; then a loader with
    ``trace_dir`` over TRACE_STEPS steps, its ``torch.profiler`` trace
    holding the B2, B3 and B1 launches."""
    tele = Telemetry()
    flight_path = os.path.join(tmp, "flight.jsonl")
    reader = make_reader(path, workers_count=workers, shuffle_seed=0, num_epochs=1,
                         decode_placement={"image": "device"}, telemetry=tele, metrics_port=0,
                         flight_record_path=flight_path, sample_interval_s=0.25)
    port = reader.metrics_server.port
    scraped = {}

    def scrape(_batch):
        if scraped:
            return
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as resp:
            scraped["text"] = resp.read().decode()

    run = train_epoch(path, "device", source=(reader, [reader]), on_batch=scrape)
    same_epoch(run, device, "phase 31, telemetry against phase 6")
    for kernel in ("normalize_u8", "resized_crop_flip_u8", "jpeg_decode_u8"):
        kernels[kernel]["launches"] += run["launches"][kernel]
    text = scraped["text"]
    series = ('petastorm_tpu_stage_busy_seconds_total{stage="decode"}',
              'petastorm_tpu_stage_busy_seconds_total{stage="device-transfer"}',
              "petastorm_tpu_queue_results_empty_wait_s_total",
              "petastorm_tpu_loader_consumer_wait_s_total")
    missing = [name for name in series if name not in text]
    if missing:
        raise AssertionError(f"phase 31: the scrape in the epoch lacks {missing}")
    snapshot = reader.diagnostics["telemetry"]
    dominant = dominant_stage(snapshot)
    if not dominant:
        raise AssertionError("phase 31: the pipeline report names no dominant stage")
    record = telemetry_sampler.flight_record(reader.sampler, reason="phase 31")
    telemetry_sampler.dump_flight_record(record, flight_path)
    loaded = telemetry_sampler.load_flight_records(flight_path)
    if len(loaded) != 1 or not loaded[0]["points"]:
        raise AssertionError(f"phase 31: the flight record holds {loaded}")
    counters = snapshot["counters"]
    if (counters["reader.rows_emitted"], counters["loader.batches_delivered"]) != (
            N_ROWS, N_ROWS // BATCH):
        raise AssertionError(f"phase 31: telemetry counted {counters}")
    return {"samples_per_s": run["samples_per_s"],
            "phase6_samples_per_s": device["samples_per_s"],
            "relative": run["samples_per_s"] / device["samples_per_s"] - 1,
            "input_idle_share": run["wait"] / run["timed"], "launches": run["launches"],
            "dominant_stage": dominant, "report": reader.telemetry.pipeline_report(),
            "scrape_bytes": len(text), "scrape_series": len(text.splitlines()),
            "sampled_points": len(loaded[0]["points"]),
            "trace": traced_steps(tmp, path, workers)}


def traced_steps(tmp, path, workers):
    """TRACE_STEPS training steps through a loader with ``trace_dir``: the
    kernels its ``torch.profiler`` trace names, and their device time."""
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16, device="cuda",
                     generator=torch.Generator().manual_seed(0)).to(
                         memory_format=torch.channels_last)
    step = trainer.TrainStep(model, 1000, SIDE, generator=torch.Generator(
        device="cuda").manual_seed(trainer.AUGMENT_SEED))
    trace_dir = os.path.join(tmp, "trace")
    reader = make_reader(path, workers_count=workers, shuffle_seed=0, num_epochs=1,
                         decode_placement={"image": "device"})
    loader = CudaDataLoader(reader, batch_size=BATCH, device="cuda", trace_dir=trace_dir)
    try:
        for k, batch in enumerate(loader):
            step(batch["image"], batch["label"] % 1000)
            if k + 1 == TRACE_STEPS:
                break
    finally:
        loader.stop()
    with open(loader.trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernel_us, kernel_n = {}, {}
    for e in events:
        if e.get("cat") == "kernel":
            kernel_us[e["name"]] = kernel_us.get(e["name"], 0.0) + float(e.get("dur", 0.0))
            kernel_n[e["name"]] = kernel_n.get(e["name"], 0) + 1
    found = {want: sorted(n for n in kernel_us if want in n)
             for want in ("jpeg_decode_tiled_kernel", "resized_crop_tiled_kernel",
                          "normalize")}
    if not all(found.values()):
        raise AssertionError(f"phase 31: the trace lacks {[k for k, v in found.items() if not v]};"
                             f" it names {len(kernel_us)} kernels")
    # the transfer thread stages units ahead of the steps until stop(): B2
    # may run more often than TRACE_STEPS
    return {"steps": TRACE_STEPS, "trace_bytes": os.path.getsize(loader.trace_path),
            "kernels_named": len(kernel_us),
            "launches": {want: sum(kernel_n[n] for n in names) for want, names in found.items()},
            "device_ms": {want: sum(kernel_us[n] for n in names) / 1e3
                          for want, names in found.items()}}


def live_split_part(tmp, path, kernels, host, device):
    """(b) One epoch with ``decode_placement={'image': 'auto'}`` and
    ``workers_count='auto'`` (the planner and autotune armed), the split set
    to ``'host'`` after step SPLIT_AFTER_STEP: B2 once on each device-form
    batch and never on a host-form one; each host-form batch's image sum is
    phase 5's for its rows (the same host decode) and each device-form
    batch's phase 6's (the same B2 on the same planes), so their labels and
    pixels carry phase 6's check against phase 5.  A second reader starts
    from the written profile."""
    location = os.path.join(tmp, "planner")
    # one worker, one results slot and one unit a loader stage bound what is
    # decoded ahead of the consumer (2 in the pool, 4 in the loader), so the
    # last rowgroups decode after the flip; the split itself is not tuned
    # under deterministic='seed', and neither are the two bounds
    split_kwargs = dict(workers_count="auto", results_queue_size=1, shuffle_seed=0,
                        num_epochs=1, decode_placement={"image": "auto"},
                        cache_location=location,
                        autotune=AutotunePolicy(max_workers=1,
                                                exclude_knobs=("results_queue", "prefetch")))
    reader = make_reader(path, **split_kwargs)
    loader = CudaDataLoader(reader, batch_size=BATCH, device="cuda", prefetch=1)
    forms = []

    def flip(_batch):
        forms.append(loader.last_decode_form)
        if len(forms) == SPLIT_AFTER_STEP:
            reader.set_decode_split("host")

    run = train_epoch(path, "auto", source=(reader, [reader]), loader=loader, on_batch=flip)
    for kernel in ("normalize_u8", "resized_crop_flip_u8", "jpeg_decode_u8"):
        kernels[kernel]["launches"] += run["launches"][kernel]
    groups = {host["labels"][k * BATCH:(k + 1) * BATCH].numpy().tobytes(): k
              for k in range(N_ROWS // BATCH)}
    for i, form in enumerate(forms):
        k = groups.get(run["labels"][i * BATCH:(i + 1) * BATCH].numpy().tobytes())
        if k is None:
            raise AssertionError(f"phase 31, live split: batch {i} is none of phase 5's")
        want = (host if form == "host" else device)["image_sums"][k]
        if run["image_sums"][i] != want:
            raise AssertionError(f"phase 31, live split: {form}-form batch {i} (phase 5's"
                                 f" batch {k}) has image sum {int(run['image_sums'][i])},"
                                 f" expected {int(want)}")
    if sorted(run["labels"].tolist()) != sorted(host["labels"].tolist()):
        raise AssertionError("phase 31, live split: other labels than phase 5")
    diag = reader.diagnostics
    counts = run["diagnostics"]["decode_split_batches"]
    if counts["device"] < 1 or counts["host"] < 1 or reader.decode_split != "host":
        raise AssertionError(f"phase 31, live split: batches by form {counts}")
    second = make_reader(path, **split_kwargs)
    with second:
        replanned = second.diagnostics["planner"]
    if replanned["knobs"]["workers"]["source"] != "profile":
        raise AssertionError(f"phase 31: the second reader planned {replanned['knobs']}")
    return {"samples_per_s": run["samples_per_s"],
            "phase6_samples_per_s": device["samples_per_s"],
            "input_idle_share": run["wait"] / run["timed"], "launches": run["launches"],
            "batches_by_form": counts, "forms_in_order": forms,
            "decode_stats": run["decode_stats"], "planner": diag["planner"],
            "autotune": diag["autotune"], "second_reader_planner": replanned["knobs"]}


def shared_tier_part(tmp, path, kernels, device, warm, workers):
    """(c) ``cache_type='shared'``: two epochs of phase 6 in this process,
    then a spawned process attached to the same namespace reading one epoch
    through the loader: every later read hits L1, with phase 6's labels and
    image sums; samples/s beside phase 14's warm local cache; ``cleanup()``
    leaves no segment."""
    location = os.path.join(tmp, "warm")
    groups = N_ROWS // ROWS_PER_GROUP
    kwargs = {"cache_type": "shared", "cache_location": location,
              "cache_size_limit": SHARED_TIER_BYTES}
    run = train_epoch(path, "device", epochs=2, reader_kwargs=kwargs)
    for kernel in ("normalize_u8", "resized_crop_flip_u8", "jpeg_decode_u8"):
        kernels[kernel]["launches"] += run["launches"][kernel]
    steps = N_ROWS // BATCH
    same_epoch({"labels": run["labels"][:steps * BATCH], "image_sums": run["image_sums"][:steps]},
               device, "phase 31, shared tier, cold epoch")
    # the warm epoch is the plan's second permutation: each of its batches
    # (one rowgroup) is one of phase 6's, with its image sum
    sums = {device["labels"][k * BATCH:(k + 1) * BATCH].numpy().tobytes():
            int(device["image_sums"][k]) for k in range(steps)}
    for i in range(steps, 2 * steps):
        key = run["labels"][i * BATCH:(i + 1) * BATCH].numpy().tobytes()
        if sums.get(key) != int(run["image_sums"][i]):
            raise AssertionError(f"phase 31, shared tier: warm batch {i - steps} is not one of"
                                 " phase 6's batches with its image sum")
    stats = run["cache_stats"]
    if (stats["misses"], stats["hits"], stats["l2_hits"]) != (groups, groups, 0):
        raise AssertionError(f"phase 31, shared tier: {stats}")
    code = (
        "import json, sys, torch\n"
        f"sys.path.insert(0, {os.path.dirname(os.path.abspath(__file__))!r})\n"
        "from petastorm_tpu_torch import make_reader\n"
        "from petastorm_tpu_torch.cuda.loader import CudaDataLoader\n"
        f"reader = make_reader({path!r}, workers_count={workers}, shuffle_seed=0, num_epochs=1,"
        f" decode_placement={{'image': 'device'}}, cache_type='shared',"
        f" cache_location={location!r}, cache_size_limit={SHARED_TIER_BYTES})\n"
        f"with CudaDataLoader(reader, batch_size={BATCH}, device='cuda') as loader:\n"
        "    got = [(b['label'].tolist(), int(b['image'].sum(dtype=torch.int64)))"
        " for b in loader]\n"
        "print(json.dumps({'labels': [x for b in got for x in b[0]],"
        " 'sums': [s for _, s in got], 'stats': reader.cache_stats()}))\n")
    t0 = time.perf_counter()
    child = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                           timeout=300)
    if child.returncode:
        raise AssertionError(f"phase 31: the attached process failed: {child.stderr[-2000:]}")
    attached = json.loads(child.stdout.strip().splitlines()[-1])
    attached_s = time.perf_counter() - t0
    if (attached["labels"] != device["labels"].tolist()
            or attached["sums"] != device["image_sums"].tolist()):
        raise AssertionError("phase 31: the attached process read other labels or images")
    if (attached["stats"]["misses"], attached["stats"]["hits"]) != (groups, 2 * groups):
        raise AssertionError(f"phase 31: the attached process's reads {attached['stats']}")
    tier = SharedWarmCache(location=location, l1_bytes=SHARED_TIER_BYTES)
    final = tier.stats()
    names = tier.segment_names
    tier.cleanup()
    left = [n for n in names if os.path.exists(os.path.join("/dev/shm", n))]
    if left:
        raise AssertionError(f"phase 31: cleanup() left {left}")
    marks = [run["timed_start"]] + run["epoch_marks"]
    per_epoch = [{"epoch": k + 1, "samples_per_s": (steps - (WARMUP_STEPS if k == 0 else 0))
                  * BATCH / (t1 - t0_), "input_idle_share": (w1 - w0) / (t1 - t0_)}
                 for k, ((t0_, w0), (t1, w1)) in enumerate(zip(marks, marks[1:]))]
    return {"samples_per_s": run["samples_per_s"], "per_epoch": per_epoch,
            "phase14_warm_memory_samples_per_s": warm["samples_per_s"],
            "phase14_per_epoch": warm["per_epoch"], "launches": run["launches"],
            "decode_stats": run["decode_stats"], "tier": final,
            "attached_process": {"seconds": attached_s, "stats": attached["stats"]},
            "segments_left": 0}


SERVICE_WORKERS, SERVICE_CAPACITY = 3, 2           # phase 32: worker processes, items each
SERVICE_KILL_AFTER_STEP = 4                       # phase 32 (c): SIGKILL a worker after it
SERVICE_SLOW_S = 1.0                              # phase 32 (c): each item's added seconds
SERVICE_WINDOW_SLACK = 4                          # phase 32: arena rowgroups past the window


def fleet_probe(addr, kind="stats?"):
    """One ``stats?`` (or ``fleet?``) probe of the dispatcher at ``addr``."""
    from petastorm_tpu_torch.service.protocol import connect_frames, parse_address

    conn = connect_frames(parse_address(addr), timeout=10.0)
    try:
        conn.send({"t": kind})
        reply = conn.recv(timeout=10.0)
    finally:
        conn.close()
    return reply[kind.rstrip("?")]


def start_fleet(tmp):
    """Phase 32's fleet, started by the port's CLI as processes of this host:
    a dispatcher on ``127.0.0.1:0`` and SERVICE_WORKERS workers, each with an
    shm arena that holds the reader's whole window of coefficient planes
    (its items at the dispatcher, those held for their turn and
    SERVICE_WINDOW_SLACK more), capped by half of ``/dev/shm``'s free space
    over the workers.  Returns (address, dispatcher, {name: worker}, arena
    MB)."""
    here = os.path.dirname(os.path.abspath(__file__))
    cli = [sys.executable, "-m", "petastorm_tpu_torch.service.cli"]
    log = open(os.path.join(tmp, "dispatcher.log"), "w")
    disp = subprocess.Popen(cli + ["dispatcher", "--host", "127.0.0.1", "--port", "0"],
                            cwd=here, stdout=subprocess.PIPE, stderr=log, text=True)
    line = disp.stdout.readline()  # "dispatcher listening on HOST:PORT"
    if "listening on" not in line:
        disp.kill()
        raise AssertionError(f"phase 32: the dispatcher did not start: {line!r}")
    addr = line.split("listening on")[1].strip()
    planes = ROWS_PER_GROUP * SIDE * SIDE * 3  # int16 Y + two 4:2:0 chroma planes
    window = 2 * max(4, 10) + SERVICE_WINDOW_SLACK  # the reader's default window
    free = shutil.disk_usage("/dev/shm").free
    arena_mb = min(window * planes, free // (2 * SERVICE_WORKERS)) >> 20
    workers = {}
    for i in range(SERVICE_WORKERS):
        name = f"w{i}"
        workers[name] = subprocess.Popen(
            cli + ["worker", "--address", addr, "--capacity", str(SERVICE_CAPACITY),
                   "--name", name, "--shm-size-mb", str(arena_mb)],
            cwd=here, stdout=subprocess.DEVNULL,
            stderr=open(os.path.join(tmp, f"{name}.log"), "w"))
    deadline = time.monotonic() + 60
    while len(fleet_probe(addr)["workers"]) < SERVICE_WORKERS:
        if time.monotonic() > deadline:
            raise AssertionError("phase 32: the workers did not register")
        time.sleep(0.1)
    return addr, disp, workers, arena_mb


def stop_fleet(disp, workers):
    """Workers first (SIGTERM: a graceful drain), then the dispatcher
    (SIGINT), each bounded, then killed; every process reaped."""
    for proc in workers.values():
        if proc.poll() is None:
            proc.terminate()
    for proc in list(workers.values()) + [disp]:
        if proc is disp and proc.poll() is None:
            proc.send_signal(2)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
    left = [p.pid for p in list(workers.values()) + [disp] if p.poll() is None]
    if left:
        raise AssertionError(f"phase 32: fleet processes left: {left}")


def service_phase(tmp, path, kernels, device, clean):
    """Phase 32: the ingest service on the main path.  Phase 6's training
    feed through a dispatcher and worker processes of the port's CLI: (a) one
    epoch, (b) the epoch again beside a host-only second tenant, both on the
    workers' shared tier, (c) a traced epoch with a worker SIGKILLed after
    step SERVICE_KILL_AFTER_STEP.  The fleet decodes an epoch in a fraction
    of the trainer's time, so in (c) every item sleeps SERVICE_SLOW_S first
    (``ChaosSpec.slow_s``): the trainer then waits on the fleet, whose
    workers hold items when the kill comes, and the same throttled epoch
    without the kill is the kill's baseline."""
    t0 = time.perf_counter()
    shm_before = set(os.listdir("/dev/shm"))
    addr, disp, workers, arena_mb = start_fleet(tmp)
    steps = N_ROWS // BATCH
    out = {"workers": SERVICE_WORKERS, "capacity": SERVICE_CAPACITY, "arena_mb": arena_mb,
           "fleet_start_s": time.perf_counter() - t0}
    try:
        def count(run, what):
            for kernel in ("normalize_u8", "resized_crop_flip_u8", "jpeg_decode_u8"):
                kernels[kernel]["launches"] += run["launches"][kernel]
            payloads = run["diagnostics"]["reader"]["payloads"]
            if payloads != {"shm": steps, "bin": 0, "pickle": 0}:
                raise AssertionError(f"phase 32, {what}: results by payload kind {payloads},"
                                     f" expected {steps} shm")
            return payloads

        def rates(run):
            idle = (run["input_idle_share"] if "input_idle_share" in run
                    else run["wait"] / run["timed"])
            return {"samples_per_s": run["samples_per_s"], "epoch_s": run["epoch_s"],
                    "input_idle_share": idle}

        # (a) the flagship feed through the fleet
        run = train_epoch(path, "device", reader_kwargs=dict(service_address=addr))
        same_epoch(run, device, "phase 32 (a) against phase 6")
        out["a"] = {**rates(run), "payloads": count(run, "(a)"), "launches": run["launches"],
                    "phase6": rates(device), "phase29": rates(clean)}
        base_epoch_s = run["epoch_s"]

        # (b) two tenants on the workers' shared tier
        location = os.path.join(tmp, "service_tier")
        tier_kwargs = dict(cache_type="shared", cache_location=location,
                           cache_size_limit=SHARED_TIER_BYTES)
        def fleet_decoded(at_least, settle_s=2.5):
            """The fleet's entropy-decoded images once the heartbeats (every
            2 s) folded at least ``at_least``, read again a heartbeat later."""
            deadline = time.monotonic() + 15
            key = "service.fleet.decode.coef_batch_images"
            while (fleet_probe(addr)["counters"].get(key, 0) < at_least
                   and time.monotonic() < deadline):
                time.sleep(0.25)
            time.sleep(settle_s)
            return fleet_probe(addr)["counters"].get(key, 0)

        decoded0 = fleet_decoded(N_ROWS)  # (a)'s epoch
        if decoded0 != N_ROWS:
            raise AssertionError(f"phase 32 (a): the fleet entropy-decoded {decoded0} images,"
                                 f" expected {N_ROWS}")
        # the workers' cost of a result's shm payload (one copy of a
        # rowgroup's coefficient planes into the arena), from their heartbeats
        encode = fleet_probe(addr, "fleet?")["merged_hists"].get(
            "stage.service.encode.latency_s", {}).get("snapshot", {})
        out["a"]["shm_encode_ms"] = {
            "count": encode.get("count"),
            "mean": 1e3 * encode.get("sum", 0.0) / max(encode.get("count") or 1, 1),
            "buckets_s": encode.get("buckets"), "counts": encode.get("counts"),
            "rowgroup_mb": ROWS_PER_GROUP * SIDE * SIDE * 3 / 1e6}
        second = {}

        def tenant():
            t_ = time.perf_counter()
            with make_reader(path, service_address=addr, shuffle_seed=1, num_epochs=1,
                             decode_placement={"image": "device"}, **tier_kwargs) as r:
                second["labels"] = sorted(int(x) for b in r.iter_batches()
                                          for x in b.columns["label"])
            second["seconds"] = time.perf_counter() - t_

        thread = threading.Thread(target=tenant)
        thread.start()
        run = train_epoch(path, "device", reader_kwargs=dict(service_address=addr, **tier_kwargs))
        thread.join(timeout=300)
        if thread.is_alive():
            raise AssertionError("phase 32 (b): the second tenant did not finish")
        same_epoch(run, device, "phase 32 (b) against phase 6")
        if second["labels"] != sorted(device["labels"].tolist()):
            raise AssertionError("phase 32 (b): the second tenant's rows differ")
        tier = SharedWarmCache(location=location, l1_bytes=SHARED_TIER_BYTES)
        stats = tier.stats()
        tier.cleanup()
        if stats["misses"] != steps or stats["hits"] + stats["l2_hits"] != steps:
            raise AssertionError(f"phase 32 (b): tier {stats}, expected {steps} misses and"
                                 f" {steps} hits")
        decoded = fleet_decoded(decoded0 + N_ROWS) - decoded0
        if decoded != N_ROWS:
            raise AssertionError(f"phase 32 (b): the fleet entropy-decoded {decoded} images,"
                                 f" expected {N_ROWS} (each rowgroup once)")
        out["b"] = {**rates(run), "payloads": count(run, "(b)"), "slowdown": run["epoch_s"]
                    / base_epoch_s - 1, "second_tenant_s": second["seconds"],
                    "tier": {k: stats[k] for k in ("misses", "hits", "l2_hits")},
                    "fleet_decoded_images": decoded}

        # (c) a worker SIGKILLed mid-epoch, the epoch traced
        slow = ChaosSpec(slow_rate=1.0, slow_s=SERVICE_SLOW_S)
        base = train_epoch(path, "device", reader_kwargs=dict(
            service_address=addr, trace_items=True, telemetry=Telemetry(), chaos=slow))
        same_epoch(base, device, "phase 32 (c), throttled, against phase 6")
        count(base, "(c) throttled")
        tele = Telemetry()
        killed = {}

        def kill(_batch):
            # from step SERVICE_KILL_AFTER_STEP on, the first worker seen
            # holding an item dies
            killed["step"] = killed.get("step", 0) + 1
            if killed["step"] < SERVICE_KILL_AFTER_STEP or "victim" in killed:
                return
            busy = sorted(name for name, w in fleet_probe(addr)["workers"].items()
                          if w["inflight"] > 0)
            if busy:
                workers[busy[0]].kill()
                workers[busy[0]].wait(timeout=30)
                killed.update(victim=busy[0], at_step=killed["step"])

        run = train_epoch(path, "device", on_batch=kill, reader_kwargs=dict(
            service_address=addr, trace_items=True, telemetry=tele, chaos=slow))
        same_epoch(run, device, "phase 32 (c) against phase 6")
        if "victim" not in killed:
            raise AssertionError(f"phase 32 (c): no worker held an item from step"
                                 f" {SERVICE_KILL_AFTER_STEP} on")
        reader_diag = run["diagnostics"]["reader"]
        requeued = tele.snapshot()["counters"].get("service.requeued_items", 0)
        if requeued < 1 or reader_diag["requeued_items"] < 1:
            raise AssertionError(f"phase 32 (c): {requeued} items requeued after the kill")
        trace = tele.trace.chrome_trace()
        tracks = {e["args"]["name"] for e in trace["traceEvents"]
                  if e.get("name") == "process_name"}
        spans = {e["name"] for e in trace["traceEvents"]
                 if e.get("cat") == "service.trace" and e.get("ph") == "X"}
        if not ({"service.item", "client.serialize"} <= spans
                and any(t.startswith("dispatcher@") for t in tracks)
                and any(t.startswith("worker:") for t in tracks)):
            raise AssertionError(f"phase 32 (c): the merged trace lacks a track: {tracks}")
        hists = tele.snapshot()["histograms"]
        from petastorm_tpu_torch.telemetry.report import hist_quantile

        # p50 is a bucket bound of the fixed latency buckets; the mean is exact
        hops = {n[len("service.hop."):]: {"count": h["count"],
                                          "p50_ms": 1e3 * hist_quantile(h, 0.5),
                                          "mean_ms": 1e3 * h["sum"] / h["count"]}
                for n, h in hists.items() if n.startswith("service.hop.") and h["count"]}
        out["c"] = {**rates(run), "payloads": count(run, "(c)"), "slow_s": SERVICE_SLOW_S,
                    "throttled_epoch_s": base["epoch_s"], "killed": killed["victim"],
                    "killed_after_step": killed["at_step"],
                    "requeued_items": requeued, "lost_s": run["epoch_s"] - base["epoch_s"],
                    "hops": hops, "trace_tracks": sorted(tracks)}
    finally:
        stop_fleet(disp, workers)
    left = sorted(set(os.listdir("/dev/shm")) - shm_before)
    if left:
        raise AssertionError(f"phase 32: shm segments left: {left}")
    phase("service_train", batch=BATCH, steps=steps, seconds=time.perf_counter() - t0,
          segments_left=0, **out)


MATRIX_SEED = 7                                   # phase 33 (c): the cells' shuffle seed
CONVERTER_ROWS = 32                               # phase 33 (d): the mock DataFrame's rows


def legacy_interop_phase(tmp, path, kernels, device):
    """Phase 33: (a) the resampling kernels of the other jax.image methods
    against their plain versions (``resample_methods_entry``); (b) phase 4's
    dataset copied into the original Petastorm's layout (the pickled
    Unischema, rowgroup counts and a ``label`` index in ``_common_metadata``,
    none of this package's metadata) and phase 6's training path over it for
    16 steps, each delivered batch also resized to EVAL_SIDE by one of the
    methods in turn (the new kernels' main-path launches), each such resize
    held to its plain version on the same batch after the run, the delivered
    images equal byte for byte to the same read of the port's own format;
    (c) determinism-matrix cells feeding ``CudaDataLoader`` over phase 6's
    dataset (thread pool, process pool with killed workers, an in-process
    service fleet): equal ``content_crc`` and stream digests; (d) the Spark
    converter example over the mocked DataFrame, on the card."""
    t0 = time.perf_counter()
    entries = resample_methods_entry()
    out = {"resample_seconds": time.perf_counter() - t0}

    # (b) a legacy Petastorm dataset through the main path
    t1 = time.perf_counter()
    legacy = os.path.join(tmp, "legacy_petastorm")
    schema = open_dataset(path).stored_schema
    written = make_legacy_dataset(path, legacy, schema, index_fields=["label"])
    info = open_dataset(legacy)
    if (interop.LEGACY_UNISCHEMA_KEY not in info.kv_metadata
            or any(k.startswith(b"petastorm_tpu") for k in info.kv_metadata)):
        raise AssertionError(f"phase 33 (b): the legacy dataset's keys {sorted(info.kv_metadata)}")
    if [(f.name, f.dtype, f.shape, type(f.codec).__name__) for f in info.stored_schema] != \
            [(f.name, f.dtype, f.shape, type(f.codec).__name__) for f in schema]:
        raise AssertionError("phase 33 (b): the legacy Unischema converts to another schema")
    index = get_row_group_indexes(info)["label"]
    for value in sorted(written["label"])[::97]:
        if index.get_row_group_indexes(value) != written["label"][value]:
            raise AssertionError(f"phase 33 (b): the legacy index gives other rowgroups for"
                                 f" label {value}")
    delivered, evals = [], []

    def on_batch(batch):
        # kept for the checks after the run (no host sync in the step)
        images = batch["image"]
        delivered.append(images.clone())
        method = EVAL_METHODS[(len(delivered) - 1) % len(EVAL_METHODS)]
        evals.append((method, augment.resize_images(images, eval_hw, method=method)))

    eval_hw = (EVAL_SIDE, EVAL_SIDE)
    run = train_epoch(legacy, "device", on_batch=on_batch)
    launches = {"resample_cubic": augment.resized_crop_kernel.launches_cubic,
                "resample_lanczos3": augment.resized_crop_kernel.launches_lanczos3,
                "resample_lanczos5": augment.resized_crop_kernel.launches_lanczos5,
                "resize_nearest": augment.nearest_kernel.launches}
    oracle = {f"general{suffix}": getattr(augment.resized_crop_kernel, f"launches_general{suffix}")
              for suffix in ("", "_cubic", "_lanczos3", "_lanczos5")}
    if any(oracle.values()):
        raise AssertionError(f"phase 33 (b): the path launched the general kernel: {oracle}")
    # each evaluation resize of the run held to its plain version on the same batch
    eval_errs = {}
    for i, (method, resized) in enumerate(evals):
        images, what = delivered[i], f"(b) {method} evaluation resize of batch {i}"
        if method == "nearest":
            if not torch.equal(resized, augment._resize_nearest_reference(images, eval_hw)):
                raise AssertionError(f"phase 33 {what}: the gather differs from the plain"
                                     f" version")
            err, share = 0.0, 0.0
        else:
            n, h, w, _ = images.shape
            inv = torch.tensor([1.0 / (EVAL_SIDE / h), 0.0, 1.0 / (EVAL_SIDE / w), 0.0],
                               device="cuda").expand(n, 4)
            err, share = hold_to_plain(resized, augment._resized_crop_reference(
                images, inv, None, eval_hw, True, method), what, False)
        name = "resize_nearest" if method == "nearest" else f"resample_{method}"
        worst = eval_errs.get(name, {"max_lsb": 0.0, "share_differing": 0.0, "batches": 0})
        eval_errs[name] = {"max_lsb": max(worst["max_lsb"], err),
                           "share_differing": max(worst["share_differing"], share),
                           "batches": worst["batches"] + 1}
    evals.clear()
    steps = N_ROWS // BATCH
    for name, count in launches.items():
        if count != steps // len(EVAL_METHODS):
            raise AssertionError(f"phase 33 (b): kernel {name} launched {count} times in"
                                 f" {steps} steps, expected {steps // len(EVAL_METHODS)}")
        entries[name]["launches"] = count
        entries[name]["max_abs_err"] = max(entries[name]["max_abs_err"],
                                           eval_errs[name]["max_lsb"])
    for kernel in ("normalize_u8", "resized_crop_flip_u8", "jpeg_decode_u8"):
        kernels[kernel]["launches"] += run["launches"][kernel]
    same_epoch(run, device, "phase 33 (b), the legacy dataset, against phase 6")
    # the same read of the port's own format, batch for batch on the card
    own = make_reader(path, workers_count=run["workers"], shuffle_seed=0, num_epochs=1,
                      decode_placement={"image": "device"})
    with CudaDataLoader(own, batch_size=BATCH, device="cuda") as loader:
        same = [torch.equal(batch["image"], delivered[i]) for i, batch in enumerate(loader)]
    if len(same) != len(delivered) or not all(same):
        raise AssertionError(f"phase 33 (b): the legacy read's images differ from the port's"
                             f" own format in batches"
                             f" {[i for i, ok in enumerate(same) if not ok]}")
    delivered.clear()
    out["b"] = {"rows": N_ROWS, "steps": run["steps"], "samples_per_s": run["samples_per_s"],
                "phase6_samples_per_s": device["samples_per_s"],
                "input_idle_share": run["wait"] / run["timed"], "launches": run["launches"],
                "eval_launches": launches, "eval_errors": eval_errs, "bytes_equal_batches": len(same),
                "legacy_index_values": len(written["label"]),
                "seconds": time.perf_counter() - t1}

    # (c) determinism-matrix cells feeding the loader on the card
    t2 = time.perf_counter()

    def cell(spec, **kwargs):
        return matrix.run_cell(path, MATRIX_SEED, spec, num_epochs=1,
                               reader_kwargs={"decode_placement": {"image": "device"}},
                               loader=lambda r: CudaDataLoader(r, batch_size=BATCH,
                                                               device="cuda"), **kwargs)

    cells = {"thread": cell(matrix.MatrixCell(workers=4)),
             "process-kill": cell(matrix.MatrixCell(workers=3, pool="process", chaos="kill"))}
    with matrix.service_fleet(n_workers=2) as (_disp, addr, _workers):
        cells["service"] = cell(matrix.MatrixCell(transport="service"), service_address=addr)
    base = cells["thread"]
    for name, result in cells.items():
        if (result.rows, result.batch_rows) != (N_ROWS, (BATCH,) * steps):
            raise AssertionError(f"phase 33 (c), {name}: {result.rows} rows in"
                                 f" {result.batch_rows}")
        if (result.content_crc != base.content_crc
                or result.digest["combined"] != base.digest["combined"]):
            raise AssertionError(f"phase 33 (c): cell {name} delivered another stream"
                                 f" (crc {result.content_crc} against {base.content_crc})")
    no_children("phase 33 (c)")
    out["c"] = {"cells": {name: {"content_crc": r.content_crc,
                                 "digest": r.digest["combined"]}
                          for name, r in cells.items()},
                "seconds": time.perf_counter() - t2}

    # (d) the Spark converter example, on the card
    t3 = time.perf_counter()
    feed = convert_and_feed_cuda.main(os.path.join(tmp, "converter_cache"), CONVERTER_ROWS,
                                      device="cuda")
    want_sum = 3 * sum(range(CONVERTER_ROWS)) + 0.75 * CONVERTER_ROWS
    if (feed["cuda_ids"] != list(range(CONVERTER_ROWS)) or feed["vec_sum"] != want_sum
            or feed["torch_rows"] != CONVERTER_ROWS or not feed["cache_hit"]):
        raise AssertionError(f"phase 33 (d): the converter example delivered {feed}")
    out["d"] = {k: feed[k] for k in ("rows", "files", "cuda_rows", "vec_sum", "torch_rows",
                                     "cache_hit")}
    out["d"]["seconds"] = time.perf_counter() - t3
    kernels.update(entries)
    phase("legacy_interop", seconds=time.perf_counter() - t0, **out)


HARNESS_BATCHES = 16                              # phase 34 (a): timed batches a loader run
HARNESS_PREFETCH = 2                              # phase 34 (a): the loader's queue bound
HARNESS_ROWS, HARNESS_ROWGROUPS = 2048, 48        # phase 34 (b): rows of --method row, batches
SCALING_WORKERS = {"thread": (1, 4, 7), "process": (1, 7)}  # phase 34 (d)


def harness_loader_run(path, workers, decode_fields=(), step_s=0.0):
    """``benchmark.cuda_loader_throughput`` over phase 4's dataset (batch
    256, WARMUP_STEPS + HARNESS_BATCHES batches) with every kernel count set
    to 0 just before and read just after: B2 once a batch the loader staged
    with ``decode_fields``, at least the batches consumed and at most those
    plus the prefetched ones and the one on the transfer thread; no other
    kernel."""
    reset_launch_counts()
    res = benchmark_throughput.cuda_loader_throughput(
        path, batch_size=BATCH, warmup_batches=WARMUP_STEPS, measure_batches=HARNESS_BATCHES,
        workers_count=workers, simulated_step_s=step_s, device_decode_fields=decode_fields,
        prefetch=HARNESS_PREFETCH, device="cuda")
    launches = kernel_launch_counts()
    what = f"phase 34 (a), decode {decode_fields or 'host'}, step {step_s} s"
    if res.samples != HARNESS_BATCHES * BATCH:
        raise AssertionError(f"{what}: {res.samples} samples, expected {HARNESS_BATCHES * BATCH}")
    consumed = WARMUP_STEPS + HARNESS_BATCHES
    b2 = launches.pop("jpeg_decode_u8")
    low, high = (consumed, consumed + HARNESS_PREFETCH + 1) if decode_fields else (0, 0)
    if not low <= b2 <= high or any(launches.values()):
        raise AssertionError(f"{what}: B2 launched {b2} times for {consumed} batches (expected"
                             f" {low}-{high}), the other kernels {launches} (expected 0)")
    return {**json.loads(res.to_json()), "jpeg_decode_u8_launches": b2}


def harness_cli(here, *args):
    """``python -m petastorm_tpu_torch.benchmark.cli`` over phase 4's dataset,
    ``--json``: its one result line."""
    out = subprocess.run([sys.executable, "-m", "petastorm_tpu_torch.benchmark.cli", *args,
                          "--json"], cwd=here, capture_output=True, text=True,
                         timeout=CHILD_TIMEOUT_S)
    if out.returncode:
        raise AssertionError(f"phase 34 (b): the CLI {args} exited {out.returncode}:\n"
                             f"{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def harness_phase(path, kernels, host, device, rates, drained):
    """Phase 34: the throughput harness (``petastorm_tpu_torch/benchmark``)
    over phase 4's dataset.  (a) ``cuda_loader_throughput`` in this process
    flat out, host decode and device decode, then host decode with phase 5's
    measured step simulated: samples, B2's launches, the stall share beside
    phase 5's input-idle share; (b) the CLI as a process, ``--method row``,
    ``batch`` (also ``--isolated``) and ``cuda --decode-device image``,
    beside phases 7 and 10; (c) ``ops_microbench`` at the JAX tool's shapes,
    its lines printed, each kernel's kept output held once to its plain
    version (B1 within 2 float32 ulp plus 1 bfloat16 ulp, B3 and B3 aa equal
    to the general kernel and within 1 LSB of the plain version on at most
    0.1 % of bytes, B2 against cv2 under phase 6's rule), its launches added
    to the ``kernels`` line; (d) ``loader_microbench`` at its defaults and
    ``scaling`` over the thread and process pools."""
    t0 = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    cores = os.cpu_count() or 2
    workers = max(1, min(cores - 1, 16))
    out = {"a": {"host": harness_loader_run(path, workers),
                 "device": harness_loader_run(path, workers, ("image",)),
                 "host_step": harness_loader_run(path, workers, step_s=host["step_s"])}}
    kernels["jpeg_decode_u8"]["launches"] += out["a"]["device"]["jpeg_decode_u8_launches"]
    out["a"]["simulated_step_s"] = host["step_s"]
    out["a"]["phase5_input_idle_share"] = host["input_idle_share"]
    out["a"]["phase6_samples_per_s"] = device["samples_per_s"]
    out["seconds_a"] = time.perf_counter() - t0

    common = [path, "-w", str(workers), "--batch-size", str(BATCH)]
    cuda_batches = ["-n", str(25 * WARMUP_STEPS), "-m", str(25 * HARNESS_BATCHES)]
    out["b"] = {
        "row": harness_cli(here, *common, "--method", "row", "-n", "256",
                           "-m", str(HARNESS_ROWS)),
        "batch": harness_cli(here, *common, "--method", "batch", "-n", "2",
                             "-m", str(HARNESS_ROWGROUPS)),
        "batch_isolated": harness_cli(here, *common, "--method", "batch", "-n", "2",
                                      "-m", str(HARNESS_ROWGROUPS), "--isolated"),
        "cuda_device_decode": harness_cli(here, *common, "--method", "cuda",
                                          "--decode-device", "image", *cuda_batches)}
    want = {"row": HARNESS_ROWS, "batch": HARNESS_ROWGROUPS * ROWS_PER_GROUP,
            "batch_isolated": HARNESS_ROWGROUPS * ROWS_PER_GROUP,
            "cuda_device_decode": HARNESS_BATCHES * BATCH}
    got = {k: r["samples"] for k, r in out["b"].items()}
    if got != want:
        raise AssertionError(f"phase 34 (b): the CLI counted {got} samples, expected {want}")
    out["b"]["phase7_rows_per_s"] = {k: rates[k]["rows_per_s"]
                                     for k in ("native", "entropy_only")}
    out["b"]["phase10_samples_per_s"] = {k: v["samples_per_s"] for k, v in drained.items()}
    out["seconds_b"] = time.perf_counter() - t0 - out["seconds_a"]

    t1 = time.perf_counter()
    outputs = {}
    reset_launch_counts()
    records = ops_microbench.run("cuda", outputs=outputs)
    launches = kernel_launch_counts()
    general = {k: launches.pop(k) for k in ("general_resized_crop", "general_jpeg_decode")}
    if min(launches.values()) < 1 or any(general.values()):
        raise AssertionError(f"phase 34 (c): ops_microbench launched {launches}, the general"
                             f" kernels {general}")
    for name, count in launches.items():
        kernels[name]["launches"] += count
    images, normalized = outputs["normalize"]
    held = {"normalize_u8": check_normalize(images, ops_microbench.MEAN, ops_microbench.STD,
                                            torch.bfloat16, got=normalized)}
    for key, name, antialias in (("crop", "resized_crop_flip_u8", False),
                                 ("crop_aa", "resized_crop_aa_u8", True)):
        big, boxes, flips, cropped = outputs[key]
        hw = tuple(cropped.shape[1:3])
        held[name] = check_resample(cropped, big, augment.crop_params(boxes, hw), flips, hw,
                                    antialias)
    bufs, planes, qtabs, layout, decoded = outputs["jpeg"]
    plain = jpeg._decode_reference(planes, qtabs, (layout.height, layout.width), layout.sampling)
    held["jpeg_decode_u8"] = within_cv2(decoded.cpu().numpy(), cv2_decode(bufs),
                                        plain.cpu().numpy(), "phase 34 (c)")
    out["c"] = {"records": records, "launches": launches, "vs_plain": held,
                "seconds": time.perf_counter() - t1}

    t1 = time.perf_counter()
    micro = loader_microbench(device="cuda")
    if not all(r["samples_per_sec"] > 0 for r in micro) or len(micro) != 12:
        raise AssertionError(f"phase 34 (d): loader_microbench gave {micro}")
    curves = {}
    for pool, counts in SCALING_WORKERS.items():
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            benchmark_scaling.main(["--pool-type", pool, "--workers", *map(str, counts),
                                    "--dataset-url", path, "--epochs", "1"])
        curves[pool] = [json.loads(line) for line in text.getvalue().splitlines()]
        got = [(r["workers"], r["samples"], r["shm_transport"]) for r in curves[pool]]
        if got != [(w, N_ROWS, pool == "process") for w in counts]:
            raise AssertionError(f"phase 34 (d): scaling over the {pool} pool gave {got}")
    out["d"] = {"loader_microbench": micro, "scaling": curves,
                "seconds": time.perf_counter() - t1}
    phase("throughput_harness", batch=BATCH, workers=workers,
          seconds=time.perf_counter() - t0, **out)


FLOAT_FEED_ROWS, FLOAT_FEED_GROUP, FLOAT_FEED_EPOCHS = 1024, 256, 2  # phase 35: the float feed
FLOAT_FEED_SIDE = 256                             # phase 35: its images' side (ImageNet's resize)
FLOAT_FEED_OTHER = (torch.float32, torch.bfloat16)  # phase 35: a batch's other dtype, in turn


def write_float_feed(path):
    """Phase 35's dataset: FLOAT_FEED_ROWS rows of an int64 ``label`` (the
    row's number) and a fixed-shape (256, 256, 3) float16 ``image`` of
    values in [0, 1) (``NdarrayCodec``), in rowgroups of FLOAT_FEED_GROUP."""
    schema = Schema("FloatImages", [
        Field("label", np.int64),
        Field("image", np.float16, (FLOAT_FEED_SIDE, FLOAT_FEED_SIDE, 3), codecs.NdarrayCodec())])
    rng = np.random.default_rng(35)
    write_dataset(path, schema, ({"label": i, "image": rng.random(
        (FLOAT_FEED_SIDE, FLOAT_FEED_SIDE, 3), dtype=np.float32).astype(np.float16)}
        for i in range(FLOAT_FEED_ROWS)), row_group_size_rows=FLOAT_FEED_GROUP)


def float_feed_phase(tmp, kernels):
    """Phase 35, a float feed: float16 images through ``make_reader`` ->
    ``CudaDataLoader(batch_size=256)`` for FLOAT_FEED_EPOCHS epochs, each
    batch cropped by ``random_resized_crop`` to 224 with drawn boxes and
    flips (the tiled kernel's float16 instance) and resized 256 -> 224
    antialiased by ``resize_images`` (the separable kernel's float16
    instance), and the same two ops on the batch cast to float32 or
    bfloat16 in turn (a user normalising to another dtype first), so every
    float instance runs on the path.  Samples/s, the input-wait share, the
    seconds a timed batch spent waiting on its copy to the card and on its
    ops (a synchronize after each), the loader's assembly and transfer
    seconds a batch, each kernel's launches (every count 0 just before the
    run, the general kernel's 0 after it); every label seen FLOAT_FEED_EPOCHS times; every
    kept crop and resize equal bit for bit to the general kernel's float32
    instance on the same batch, cast back, after the timed loop."""
    t0 = time.perf_counter()
    path = os.path.join(tmp, "float_feed")
    write_float_feed(path)
    write_s = time.perf_counter() - t0
    workers = max(1, min((os.cpu_count() or 2) - 1, 16))
    reader = make_reader(path, workers_count=workers, shuffle_seed=0,
                         num_epochs=FLOAT_FEED_EPOCHS)
    gen = torch.Generator(device="cuda").manual_seed(35)
    side, out_hw = FLOAT_FEED_SIDE, (SIDE, SIDE)
    kept, labels = [], []
    copy_wait = ops_s = 0.0  # timed batches: the wait on a batch's copy, then its ops
    torch.cuda.synchronize()
    reset_launch_counts()
    with CudaDataLoader(reader, batch_size=BATCH, device="cuda") as loader:
        for i, batch in enumerate(loader):
            t1 = time.perf_counter()
            torch.cuda.synchronize()  # the batch's copy to the card done
            t2 = time.perf_counter()
            images = batch["image"]
            boxes = augment.draw_crop_boxes(BATCH, side, side, gen, device="cuda")
            flips = augment.draw_flips(BATCH, gen, "cuda")
            crop = augment.random_resized_crop(images, None, out_hw, boxes=boxes, flips=flips)
            resized = augment.resize_images(images, out_hw, antialias=True)
            other = images.to(FLOAT_FEED_OTHER[i % len(FLOAT_FEED_OTHER)])
            other_out = (augment.random_resized_crop(other, None, out_hw, boxes=boxes,
                                                     flips=flips),
                         augment.resize_images(other, out_hw, antialias=True))
            labels.append(batch["label"])
            # kept for the checks after the run (no host sync in the loop)
            kept.append((images.clone(), boxes, flips, crop, resized, other_out))
            torch.cuda.synchronize()
            if i > 0:
                copy_wait += t2 - t1
                ops_s += time.perf_counter() - t2
            if i == 0:
                torch.cuda.synchronize()
                timed_start, wait0 = time.perf_counter(), loader.diagnostics()["consumer_wait_s"]
        torch.cuda.synchronize()
        end = time.perf_counter()
        diagnostics = loader.diagnostics()
        wait = diagnostics["consumer_wait_s"] - wait0
    k = augment.resized_crop_kernel
    counts = {suffix[1:]: getattr(k, "launches" + suffix) for suffix in augment.LAUNCH_COUNTERS}
    batches = len(kept)
    want_batches = FLOAT_FEED_EPOCHS * FLOAT_FEED_ROWS // BATCH
    turns = [sum(1 for i in range(batches) if FLOAT_FEED_OTHER[i % 2] == dt)
             for dt in FLOAT_FEED_OTHER]
    want = dict.fromkeys(counts, 0)
    want.update(tiled=2 * batches, aa=2 * batches, tiled_f16=batches, separable_f16=batches,
                tiled_f32=turns[0], separable_f32=turns[0], tiled_bf16=turns[1],
                separable_bf16=turns[1])
    if batches != want_batches or counts != want:
        raise AssertionError(f"phase 35: {batches} batches (expected {want_batches}), launches"
                             f" {counts}, expected {want}")
    seen = torch.bincount(torch.cat(labels).cpu(), minlength=FLOAT_FEED_ROWS)
    if seen.numel() != FLOAT_FEED_ROWS or not bool((seen == FLOAT_FEED_EPOCHS).all()):
        raise AssertionError(f"phase 35: labels seen {seen.unique().tolist()} times, expected"
                             f" each {FLOAT_FEED_EPOCHS}")
    # each kept crop and resize against the general kernel's float32 instance
    inv = torch.tensor([1.0 / (SIDE / side), 0.0, 1.0 / (SIDE / side), 0.0],
                       device="cuda").expand(BATCH, 4)
    errs = {}
    for i, (images, boxes, flips, crop, resized, other_out) in enumerate(kept):
        params = augment.crop_params(boxes, out_hw)
        other = images.to(FLOAT_FEED_OTHER[i % len(FLOAT_FEED_OTHER)])
        for x, got_crop, got_resized in ((images, crop, resized), (other, *other_out)):
            what = f"phase 35, batch {i} {x.dtype}"
            same_bits(got_crop, float_oracle(x, params, flips, out_hw, False), what + " crop")
            same_bits(got_resized, float_oracle(x, inv, None, out_hw, True), what + " resize")
            if i < 2:  # and the first batches against the plain version
                for got, p, f, a in ((got_crop, params, flips, False),
                                     (got_resized, inv, None, True)):
                    errs[str(x.dtype)] = max(errs.get(str(x.dtype), 0.0), hold_float_to_plain(
                        got, x, p, f, out_hw, a, "linear", what))
    kept.clear()
    for name, count in (("resized_crop_flip", "tiled"), ("resized_crop_aa", "separable")):
        for element in ("f32", "f16", "bf16"):
            kernels[f"{name}_{element}"]["launches"] = counts[f"{count}_{element}"]
            kernels[f"{name}_{element}"]["max_abs_err"] = max(
                kernels[f"{name}_{element}"]["max_abs_err"],
                errs.get(str({"f32": torch.float32, "f16": torch.float16,
                              "bf16": torch.bfloat16}[element]), 0.0))
    timed = end - timed_start
    phase("float_feed", rows=FLOAT_FEED_ROWS, epochs=FLOAT_FEED_EPOCHS, batch=BATCH,
          image=[FLOAT_FEED_SIDE, FLOAT_FEED_SIDE, 3], dtype="float16", workers=workers,
          batches=batches, timed_batches=batches - 1,
          samples_per_s=(batches - 1) * BATCH / timed, input_wait_share=wait / timed,
          copy_wait_s_per_batch=copy_wait / (batches - 1), ops_s_per_batch=ops_s / (batches - 1),
          loader_s_per_batch={key: diagnostics[key] / batches for key in ("assemble_s",
                                                                          "transfer_s")},
          launches=counts, other_dtype_batches={str(dt): n for dt, n in zip(FLOAT_FEED_OTHER,
                                                                            turns)},
          equals_general_f32_batches=batches, plain_max_abs_err=errs,
          dataset_write_s=write_s, seconds=time.perf_counter() - t0)


SERVICE_AB_SLOW_S = 0.25                          # --service-ab: a tierless tenant's item sleep


def service_tenants_ab():
    """``python3 chip_smoke.py --service-ab`` (not run by default): phase 32
    (b)'s cost taken apart on phase 6's feed through a fleet started as in
    phase 32.  The trainer's epoch beside a second tenant, in turns twice:
    the tenant on a thread of the trainer's process or in a process of its
    own, on a fresh shared tier or without one (then its items sleep
    SERVICE_AB_SLOW_S, so its read lasts about as long as a tier tenant's);
    then the workers' shm encode times over every run.  One JSON line a
    run."""
    build.build_all()
    for name in native_build.LIBS:
        native_build.build(name)
    kernels = {k: {"launches": 0} for k in ("normalize_u8", "resized_crop_flip_u8",
                                           "resized_crop_aa_u8", "jpeg_decode_u8")}
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="service_ab_") as tmp:
        path, _ = main_path_phase(tmp, kernels)
        addr, disp, workers, _ = start_fleet(tmp)
        try:
            alone = train_epoch(path, "device", reader_kwargs=dict(service_address=addr))
            phase("service_ab", run="alone", samples_per_s=alone["samples_per_s"],
                  epoch_s=alone["epoch_s"])
            runs = [(tier, where) for _ in range(2) for tier in (True, False)
                    for where in ("thread", "process")]
            for k, (tier, where) in enumerate(runs):
                location = os.path.join(tmp, f"ab_tier{k}")
                tier_kwargs = (dict(cache_type="shared", cache_location=location,
                                    cache_size_limit=SHARED_TIER_BYTES) if tier else {})
                second = dict(shuffle_seed=1, num_epochs=1, service_address=addr,
                              decode_placement={"image": "device"}, **tier_kwargs)
                if not tier:
                    second["chaos"] = ChaosSpec(slow_rate=1.0, slow_s=SERVICE_AB_SLOW_S)
                done = {}
                if where == "thread":
                    def tenant():
                        t0 = time.perf_counter()
                        with make_reader(path, **second) as r:
                            done["rows"] = sum(b.num_rows for b in r.iter_batches())
                        done["seconds"] = time.perf_counter() - t0
                    thread = threading.Thread(target=tenant)
                    thread.start()
                else:
                    code = ("import json, sys, time\n"
                            f"sys.path.insert(0, {here!r})\n"
                            "from petastorm_tpu_torch import make_reader\n"
                            "from petastorm_tpu_torch.test_util.chaos import ChaosSpec\n"
                            f"kw = {dict(second, chaos=None)!r}\n"
                            + (f"kw['chaos'] = ChaosSpec(slow_rate=1.0, slow_s={SERVICE_AB_SLOW_S})\n"
                               if not tier else "kw.pop('chaos')\n")
                            + "t0 = time.perf_counter()\n"
                            f"with make_reader({path!r}, **kw) as r:\n"
                            "    rows = sum(b.num_rows for b in r.iter_batches())\n"
                            "print(json.dumps([rows, time.perf_counter() - t0]))\n")
                    child = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                                             text=True)
                run = train_epoch(path, "device", reader_kwargs=dict(service_address=addr,
                                                                     **tier_kwargs))
                if where == "thread":
                    thread.join(timeout=300)
                else:
                    done["rows"], done["seconds"] = json.loads(
                        child.communicate(timeout=300)[0].strip().splitlines()[-1])
                if done.get("rows") != N_ROWS:
                    raise AssertionError(f"--service-ab: the second tenant read {done}")
                if tier:
                    SharedWarmCache(location=location, l1_bytes=SHARED_TIER_BYTES).cleanup()
                phase("service_ab", run=k, tenant=where, tier=tier,
                      samples_per_s=run["samples_per_s"], epoch_s=run["epoch_s"],
                      input_idle_share=run["wait"] / run["timed"],
                      relative=run["samples_per_s"] / alone["samples_per_s"] - 1,
                      second_tenant_s=done["seconds"])
            encode = fleet_probe(addr, "fleet?")["merged_hists"].get(
                "stage.service.encode.latency_s", {}).get("snapshot", {})
            phase("service_ab_encode", count=encode.get("count"),
                  mean_ms=1e3 * encode.get("sum", 0.0) / max(encode.get("count") or 1, 1),
                  buckets_s=encode.get("buckets"), counts=encode.get("counts"))
        finally:
            stop_fleet(disp, workers)


def main():
    started = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    phase("env", torch=torch.__version__, cuda=torch.version.cuda,
          python=sys.version.split()[0], cpu_count=os.cpu_count())
    print(smi.splitlines()[0], flush=True)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        # g++, beside the nvcc builds
        host = {name: pool.submit(native_build.build, name) for name in native_build.LIBS}
        libs = build.build_all()
        libs.update({name: job.result() for name, job in host.items()})
    phase("build", seconds=time.perf_counter() - t0, libjpeg=native_build.find_libjpeg(),
          libpng=native_build.find_libpng(),
          libraries={k: os.path.relpath(v) for k, v in libs.items()},
          jpeg_decode_kernels=b2_compiler_facts())

    kernels = kernels_phase()
    kernels.update(block_attention_entry())
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        path, main_samples_per_s = main_path_phase(tmp, kernels)
        host = train_path_phase(path, kernels)
        device = train_path_device_decode_phase(path, kernels, host)
        rates = reader_rate_phase(path)
        shuffled_train_path_phase(path, device)
        adapter_phase(path, main_samples_per_s)
        drained = drained_inference_phase(path, main_samples_per_s)
        scan = scan_train_phase(path, device)
        checkpoint_resume_phase(path, host, scan["loss_bound"])
        shuffled_inference_phase(path, main_samples_per_s)
        warm = warm_cache_train_phase(path)
        filtered_train_phase(path, kernels, device)
        transformed_train_phase(path, kernels, host)
        mixed_train_phase(tmp, path, kernels, device)
        ngram_train_phase(tmp, kernels, host, rates)
        part_path = partitioned_train_phase(tmp, kernels, device)
        poisoned_train_phase(tmp, part_path, kernels, host, device)
        mixed_geometry_train_phase(tmp, kernels, device)
        converter_train_phase(tmp, path, kernels, host)
        token_feed_phase(tmp)
        mnist_phase(tmp, kernels)
        torch.cuda.empty_cache()
        selfcheck_phase(tmp, kernels)
        long_context_phase(tmp, kernels)
        data_parallel_phase(tmp, path, kernels)
        remote_read_phase(tmp, path, kernels, device)
        clean = process_pool_phase(path, kernels, host, device)
        chaos_phase(path, kernels, clean, device)
        observability_phase(tmp, path, kernels, host, device, warm)
        service_phase(tmp, path, kernels, device, clean)
        legacy_interop_phase(tmp, path, kernels, device)
        harness_phase(path, kernels, host, device, rates, drained)
        float_feed_phase(tmp, kernels)

    phase("wall", seconds=time.perf_counter() - started)
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--packed-mesh-rank"]:
        packed_mesh_rank(json.loads(sys.argv[2]))
    elif sys.argv[1:2] == ["--service-ab"]:
        service_tenants_ab()
    else:
        main()
