#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (written for the H100).

    python3 chip_smoke.py

Phases, each timed:

0. device: the card's name, count, and its ``nvidia-smi`` name and power limit;
1. build: one ``nvcc`` per source in
   ``spherical_dyffusion_tpu_torch/csrc``, all started together, linked into
   one library; prints its seconds and the ``-Xptxas -v`` register, spill
   and shared-memory lines, and checks with ``cuobjdump -sass`` that K1's
   TF32 kernel, the two TF32 instances of dW's kernel (128 and 64 co a
   block), the eight 16-bit K2/K3 instances (four bf16, four float16) and
   the four 16-bit K4 instances run their products as HGMMA (``wgmma``);
2. K1 (dhconv, 3xTF32 on the tensor cores) at the main path's shape, batch 1
   and 2, through a weight image made once (the image kernel against its
   plain version, and timed apart), against its plain version, with the
   function's bound (its products at the TF32 peak), the bound of three
   TF32 passes over the hi/lo image and the bound of a float32 CUDA-core
   kernel. Every kernel, plain version and library call is timed the same
   way, in a loop of calls between CUDA events; K1 and K4 are also timed
   with the calls queued behind a spin kernel (``device_ms``), which leaves
   out the host work a fast kernel may wait on in such a loop;
3. K2 (fused MLP) at the main path's shapes in bf16 (the forecaster's 64,800
   rows with the float32 residual, and the interpolator's call: 129,600 rows,
   no residual, dropout 0.1), against its plain version, plus its dropout
   statistics and the weight repack kernel against its plain permutation;
   times with dropout off and on;
4. K3 (fused block tail) at the main path's shapes (batch 1 with the
   float32 residual, batch 2 without), straddling tiles, erf gelu, dropout
   masks and float32, against its plain version; K3 with A = 1, C = 0
   against K2, bit for bit; times at batch 2 with dropout off and on;
5. K4 (the CP rank pipeline's fused Legendre analysis, scale and
   synthesis, the zero Legendre triangle skipped from ``l_first``) at the
   fast window's shape (h 180, l = m = 144, R 64) at batch 1 and 2 in bf16
   and float32, at the Pallas prototype's own shape (l = m = 181), on the
   0.25-degree grid (h 721, which the bf16 kernel walks in chunks) and at a
   ragged shape, against its plain version, with its bound over the triangle
   and the dense bound;
6. the window path: both SFNOs at embed 256 x 8 layers on 180 x 360, bf16
   compute (the transforms and dhconv with bf16 operands), K1 and K2 on,
   weights from a seed, one 12-step ``run_window`` (two horizon-6
   segments) at batch 1, cold-sampled by the double-batch scan sampler,
   with the kernels' launch counts (one weight repack per bf16 K2 or K3
   launch, and no K1 weight image: the models made theirs in the warm-up
   window); then the same window with dropout off
   through the kernels and through the plain path, in bf16 and in float32;
7. the fused-tail path: the same window with K1 and K3 (``fused_tail``), the
   peeled sampler and ``scan_layers``, with its launch counts and the
   interpolator's batch sizes; then dropout off, kernels against the plain
   path in float32 and bf16;
8. the fast window (``main_path.FAST_WINDOW``: CP rank 0.25, thresholding
   0.8, bf16 spectral IO, scan and peel, the block MLP unfused) with K4,
   launched 6 x per SFNO forward (blocks 1-6; blocks 0 and 7 change grid and
   contract in spectral space) and K1-K3 never; then dropout off, K4 against
   the plain path in float32 and bf16;
10. the rollout (run after phase 8): the product path of
   ``main_path.product_rollout`` on the fused-tail path at 256 x 8 with bf16
   weights (``params_dtype``), bf16 predictions (``preds_dtype``) and the
   forecaster's EMA weights drawn from seed 1: one warm-up window, then
   ``run_inference`` of 288 steps in three 96-step windows with the
   aggregator on, its rate, sim-yr/day and ``time/*`` splits, K1 and K3
   1,536 launches a window and no K1 weight image made; every log and the
   final state finite; then the same timed rollout with the prediction
   writer (``bench.py:product_bench``'s default, ``main_path.product_rollout``
   with ``writer_dir``) into a temporary directory on the same stepper and
   seed (``phase10_writer``): the free space first, the timed run under the
   sync debug mode "error" (each window's host copy waited on by an event,
   which the mode does not count), both runs' steady rates, sim-yr/day and
   ``time/*`` splits, the bytes written, the appends' MB/s and the close's
   seconds, K1 and K3 1,536 launches a window, the logs equal bit for bit
   to the run without the writer, and ``run_dataset_inference`` over the
   written file against the rollout's per-step logs (1e-6); one 12-step
   rollout at ensemble 2 (CRPS and SSR in its logs); with dropout off, a 24-step ``run_inference`` in two 12-step
   windows over a source that does not repeat, run under the sync debug
   mode "error" (no synchronizing CUDA call before the end sync), against
   two ``run_window`` calls chained by hand on inputs read from the source
   here, and the aggregator's per-step RMSE and bias tables against float64
   numpy;
9. profile (run last: a ``torch.profiler`` session leaves a launch cost in
   the process, which launch-bound figures of later phases would carry):
   one ``torch.profiler`` pass over one window of each path, the top 10
   CUDA kernels by total time and the kernel time by group;
11. training (run right after the build, while the process holds nothing
   else, so that its peak memory is training's own): (a) K1's backward at the main path's shapes, batch
   1 and 2: dx (K1 over the conjugate-transposed image) and dW
   (``dhconv_wgrad_tc_kernel``, its two instances, 128 and 64 co a block,
   with the split partials' reduction where its plan splits) against
   autograd of the plain version and its own plain version, the same bits on
   a second call, its plan (splits, blocks, workspace), the backward image
   against its plain version, and the dx kernel (event loop and
   ``device_ms``), the backward image, the dW kernel and its ratio to one
   complex ``torch.matmul`` (also on the "w" = 2 and 4 shards), one complex
   ``torch.matmul`` computing dx and autograd of complex ``torch.matmul``
   (dx and dW) timed; (b) ``main_path.train_steps`` at 256 x 8, 180 x 360,
   float32, K1 on: 6 interpolator steps, then 6 forecaster steps with the
   interpolator frozen in ``p_losses``: per-step losses (finite), the median
   step ms after 2 warm-up steps, steps/s, the forward / backward /
   optimizer-and-EMA split (CUDA events), peak device memory, K1 launches
   per step (8 forward and 8 dx per trained SFNO, 8 more for the frozen
   interpolator in a forecaster step) and K1 images per step (16, and 8
   more at the forecaster's first step); the loss at a fixed timestep on a
   batch repeated for 10 steps (dropout off, constant lr) falls; (c) with
   dropout off and the timesteps fixed, 3 steps of each experiment at
   constant lr 4e-4 through the kernels against 3 through the plain path
   from the same weights and batches: at every step the loss (1e-5
   relative), every gradient (1e-4 of its largest entry, or of 1e-4 of the
   network's where it cancels below that; where the L1 loss's sign flips at
   an output entry, the plain path's gradient taken at the kernels' output
   cotangent), every gradient finite and every filter weight's non-zero
   (F5); the parameters after the 3 updates (1e-6 plus AdamW's response to
   the measured gradient difference);
12. checkpoints and the command lines (run right after phase 11), in a
   temporary directory: (a) ``train.run_model`` with
   ``experiment=debug_interpolation``, then ``debug_dyffusion`` with the
   first run's checkpoint as its interpolator, through the port's JSON
   configs with dotlist overrides: embed 256 x 8 on 180 x 360, 35 channels
   and 2 forcings, batch 1, K1 on, 2 steps each: every step's ms
   (synchronized) with its K1 launches (16 and 24 a step, 8 of them dx, as
   in phase 11), each checkpoint's bytes and write seconds, its read seconds,
   and its parameters and EMA reloaded bit for bit; (b)
   ``run_inference.main_from_config`` from the forecaster's checkpoint: 24
   steps in windows of 12, K1 and K3 in both networks, bf16 compute and
   transforms, the EMA: steps/s, 8 K1 and 8 K3 launches per SFNO forward,
   ``metrics.json`` finite; then float32 with the interpolator's dropout
   off through the kernels and the plain path: final states and logs within
   1e-4; (c) a reference Lightning checkpoint built from (a)'s networks
   (``sfno_flax_to_torch``, ``model.model.*``, ``model.interpolator.model.*``,
   ``model_ema.*``, SFNO/datamodule/DYffusion hyperparameters), loaded by
   ``load_experiment_checkpoint`` with gelu_exact, exact_norm and
   exact_dropout and its weights equal bit for bit; a 12-step window with K1
   and the exact dropout live, whose host-to-device bytes in one window
   (counted by a dispatch mode that sees every aten op, beside a 1 MiB
   control copy) stay below 1% of one activation;
   dropout off, kernels against the plain path within 1e-4; (d)
   ``results/skill_fast08/forecaster.msgpack`` decoded by
   ``utils/flax_msgpack.py`` and loaded strictly into its SFNO;
13. the model options at 256 x 8 on 180 x 360 (run after phase 17):
   (a) the Tucker window (``main_path.TUCKER_WINDOW``: Tucker rank 0.25 on
   the rank pipeline, 2R = 128, bf16, scan and peel, K3 on): one warm-up
   and one timed 12-step window beside phase 7's, K3 launched 192 x and
   K1, K2, K4 never; then float32 with dropout off, K3 against the plain
   path (1e-4 of the largest prediction); (b) phase 7's fused-tail window
   with ``sht_fold_symmetry``: its seconds beside phase 7's, K1 and K3 192
   launches each; float32 with dropout off, folded against unfolded from
   the same weights (1e-4); (c) ``main_path.train_steps`` on
   ``build_training(scan_layers=True, checkpointing=3)``: float32, K1 on,
   dropout and DropPath live, 6 steps of each experiment, the median step ms
   and peak memory beside phase 11's (both from a card that the earlier
   phases left empty); per step 16 K1 forwards (8 of them
   the recompute) and 8 dx per trained SFNO, 8 more forwards of the frozen
   interpolator in a forecaster step, 16 K1 weight images; then 3 steps of
   each experiment with remat and 3 without, from the same weights,
   batches and generator seed, dropout live: at every step the losses and
   every gradient within 1e-6 of the tensor's largest entry and the
   generators' states equal; (d) one float32 forward at batch 1 of each
   other option (TT rank 0.25, Tucker in spectral space, the non-linear
   filter shared and per degree, layer norm, the FFT transform with K1,
   ``lon_method="fft"`` with K1, the merged dhconv, a separable dhconv, and
   the diagonal filter at embed 64, since at 256 its weight is 17.1 GB a
   block): finite, its ms; and one forecaster training step with
   ``data+noise-v2`` on a model built with the extra condition channels:
   its loss finite and, in one step under the dispatch mode, no
   activation-sized bytes copied from the host.
14. (see ``phase14``) training's other modes at 256 x 8;
15. the ACE family at 256 x 8 on 180 x 360, batch 1 (run after phase 14): (a)
   ``main_path.ace_rollout`` (``bench.py:ace_bench``: 36 -> 35 channels,
   the dry-air corrector and the prescribed ocean, bf16, K1 and K3 with
   norm1's affine alone), 48 steps in 12-step windows with the aggregator
   and the diagnostics on: each window's seconds on the device, the steady
   steps/s and sim-yr/day, K1 and K3 96 launches a window; then the same
   rollout counted by the dispatch mode (one window's upload a window, 0
   bytes where the upload cache holds the looped source's window) under
   the sync debug mode "error" up to its end sync; (b) one window with
   the kernels against the plain path (erf gelu and two-pass norms, as the
   ACE loader builds): float32 1e-4, bf16 at most BF16_TAIL_VS_PLAIN times
   the plain path's own gap; (c) each step's global mean of dry-air
   surface pressure equal to its input's (in Pa), the surface temperature
   the target's where the mask rounds to 1, every field finite; (d) the
   float32 kernel stepper saved as a native ACE checkpoint (reference
   names), loaded, and run by ``run_inference`` with ``stepper_type: ace``
   (12 steps, K1 and K3 96 launches): its fields equal to the stepper's
   own on the same frames (1e-5); (e) ``main_path.simultaneous_steps``
   (horizon 2, ``horizon_at_once`` 1, float32, K1): the median step ms, its
   split and peak memory, 16 K1 forwards and 16 dx a step, K2-K4 never;
   3 steps at constant lr through the kernels against the plain path
   (losses 1e-5); in float16 (``compute_dtype`` and ``sht_matmul_dtype``;
   K1 float32), 3 steps through K1 after 2 with their ms, the first step's
   loss against the float32 plain path's within F16_WINDOW_VS_PLAIN times
   the float16 plain path's own gap or the float32 rule's 1e-5 relative,
   every gradient finite, and the parameter tensors whose
   float16 gradient underflows to zero counted; (g) float16 on the ACE path:
   (b)'s window and (c)'s physics also in float16 (K1, K3's float16
   instance) under phase 23's rule and (c)'s Pa tolerance, and
   ``ace_rollout(dtype="float16")``'s steady steps/s beside (a)'s bf16;
   (h) ACE's slab ocean through ``run_inference`` (the run config's
   ``ocean.slab``; a native checkpoint of ``build_ace(slab=True)``, whose
   network predicts the six surface fluxes the slab reads; a netCDF file of
   ``AceBenchSource`` frames with the mixed-layer depth and Q-flux): 12
   steps with K1 and K3 against the plain path (1e-4), and each step's
   surface temperature over the ocean against the slab tendency computed in
   float64 (4 float32 spacings); (f) (run last in the phase: a profiler
   pass) one warm ACE window under ``torch.profiler``: its launches and
   kernel time by group against (a)'s steady window.
16. (run after phase 10, as is phase 17) the UNet at
   the published width of ``configs/model/unet.json`` (dim
   64, ``dim_mults`` (1, 2, 4, 8), dropouts 0.1, bilinear resampling 180 x
   360 -> 184 x 368; 35.4 M parameters), float32, batch 1, the main path's
   channels, cuDNN's TF32 convolutions at torch's default: (a) each
   network's forward ms and peak memory; (b) a 12-step DYffusion window
   with the interpolator's dropout live (``main_path.unet_window``): its
   seconds, the forwards counted by hooks, steps/s; (c) 3 training steps of
   each experiment (``main_path.unet_train_steps``): step ms and peak
   memory; (d) the train command line with ``model=unet`` (2 steps of each
   experiment), then ``run_inference`` for 12 steps from the forecaster's
   checkpoint; K1-K4 launched no time in (a)-(d) (the UNet has no
   hand-written kernel); (e) at debug size with dropout and TF32 off, the
   card's output against the CPU's for the same weights (1e-4);
17. the parallel path on one card: ``maybe_init_multihost`` with
   ``SPHDY_COORDINATOR`` at a free local port, one process: an NCCL group
   of one; ``distributed_sht``, ``distributed_isht`` and
   ``distributed_dhconv`` (scatter on and off) at 256 channels on 180 x 360
   against ``ops/sht.py``'s transforms and the dense contraction (1e-5
   relative); 3 interpolator training steps at 256 x 8 through K1 with
   ``grad_reduce_dtype="bfloat16"`` and ``zero_shard_opt_state=True``
   against the plain trainer's, bit for bit (a mesh of one rank skips both,
   as JAX does at mesh size 1), K1's launches counted; the group destroyed.
   Two ranks cannot share one card's NCCL communicator: the multi-rank
   numerics are the CPU tests' (gloo, 2 and 4 processes).
21. spatial model parallelism (run after phase 13; ``phase21``): (a) K1
   on the channel shards of "w" = 2 and 4 (CI 128 and 64 -> 256 on (1,
   180, 181)) against its plain version (1e-5) with its ms, bound and
   complex ``torch.matmul``'s ms; (b) K3 and K2 in bf16 at batch 2 with
   dropout 0.1 on the four blocks of h = 2, w = 2 and the two of h = 2, at
   their origins: the whole grid's dropped elements, bit for bit or not,
   and within 1e-2 of the plain version at the origin, with the ms at an
   origin beside the whole grid's and the same rows without the row map;
   (c) phase 7's fused-tail window with ``make_mesh(1, 1, 1)`` over an NCCL
   group of one attached to both SFNOs, against the same window without the
   mesh (at most BF16_TAIL_VS_PLAIN times the route's own bf16 error), K1
   and K3 launched as without the mesh, its seconds beside phase 7's; (d)
   K4 at the fast window's shape (B 1, h 180, l = m = 144, R 64) on the
   channel shards of "w" = 2 and 4 and with the whole analysis and the 90
   synthesis rows of each "h" = 2 block, bf16 and float32, against its
   plain version (1e-2, 1e-5), its ms (event loop and queued behind a
   spin), plain, library and bound beside the whole grid's; (e) phase 8's
   fast window on the same route, as (c), K4 launched 144 x both ways,
   its seconds beside phase 8's; (f) one float32 forward of each routed
   filter option at 256 x 8 (the diagonal filters at embed OPT_DIAG_EMBED;
   the folded Legendre stage and the planar FFT transform through K1, 8
   launches each) on the route against the same model without the mesh
   (1e-4), with the collectives its route makes; (g) phase 13's folded
   window on the same route, as (c), K1 and K3 launched 192 x both ways,
   its seconds beside phase 13's; (h) phase 16's published UNet on the
   same route (``UNet.set_mesh``, ``phase21_unet``): with cuDNN's TF32 off
   one interpolator forward with dropout live within 1e-5 and the 12-step
   window within 1e-4 of the same stepper's without the mesh; with TF32 on
   the window's seconds both ways beside phase 16's, the collectives by
   kind, K1-K4 launched no time; the bytes over "h" and "w" a forward at
   h = 2, w = 2 and at h = 4 by level, from every rank's block with its
   collectives recorded, not made.
18. the netCDF data layer (run after phase 15, before the profile), in a
   temporary directory: a dataset written by ``data/hdf5.py:write_hdf5``
   (this machine has no h5py) with the 34 state names, the two forcings and
   the mask of ``configs/datamodule/fv3gfs.json`` on 180 x 360, float32
   from a numpy seed (9.6 MB a step): ``data/ic_0001`` in two files of 8
   steps, ``data/validation/ic_0011`` in files of 13 and 12, and
   ``stats/centering.nc`` and ``scaling.nc``; (a) ``NetCDFTimeSeries``
   windows equal to the written arrays bit for bit, a 12-step window's
   bytes, seconds and MB/s; (c) ``train.run_model`` with
   ``datamodule.kind: fv3gfs``: 2 interpolator steps at 256 x 8, float32,
   K1 on, finite losses, the normalizer equal to the stats files, K1's
   forward and dx launches a step; (b) ``run_inference`` over
   ``validation_loader.dataset.data_path`` (the validation member) from a
   forecaster checkpoint (seeded weights, (c)'s interpolator), 24 steps in
   12-step windows, bf16, the fused-tail path (peel, ``scan_layers``, K1
   and K3, 192 launches each a window): the predictions and logs equal bit
   for bit to the same rollout over an in-memory source of the same arrays
   (defined here, not in the package), steps/s with and without the first
   window, ``time/data_loading``; (d) ``run_dataset_inference`` on a
   predictions file of (b)'s denormalized predictions, (E, T, H, W) per
   variable: its logs equal to the aggregator's on the same arrays (1e-6).
19. the rollout's output files (run after phase 18, before the profile), in a
   temporary directory, through ``run_inference.main_from_config``, each
   file read back through ``data/hdf5.py``: (a) DYffusion from seeded
   checkpoints over the debug datamodule at 256 x 8 on 180 x 360 (35 state
   fields, two forcings), the fused-tail path with K1 and K3 from the run
   config's overrides, bf16, ensemble 2, two 12-step windows, every
   ``data_writer`` option with ``time_coarsen_factor`` 4 and 7 of the 35
   names saved, and ``log_video``: the prediction file equal to the
   recorded predictions coarsened in numpy, each histogram's counts summing
   to the values written and equal, with its edges, to ``DynamicHistogram``
   over the same windows, the video file's ``gen_mean`` the coarsened
   ensemble mean, ``videos.nc`` one ``{key}/{name}`` dataset per key and
   name with the ensemble mean, K1 and K3 192 launches a window; (b) ACE
   from a native checkpoint of ``ace_bench``'s float32 stepper (K1 and K3
   from the overrides) with the prediction file, two 12-step windows: the
   file equal to the predictions ``run_ace_inference``'s ``on_window``
   hands over, K1 and K3 96 launches a window; (a)'s snapshot and zonal-mean
   PNGs read back through ``evaluation/plots.py:read_png`` against the
   aggregator's maps coloured.
20. the port against the float64 oracles and the last utilities (run
   after phase 19, before the profile): (a) a reference-format checkpoint
   pair fabricated at PARITY_EMBED x PARITY_LAYERS on PARITY_SHAPE
   (``utils/parity_window.py``), loaded through ``load_reference_checkpoint``
   on the card in float32, one PARITY_STEPS-step window with K1 and K3 and
   one with K1 and K2 (``run_window_parity_check``), each step within 1e-4
   of the float64 window oracle, which a process of its own computes on the
   CPU from phase 0 on (``start_parity_oracle``), with its host seconds and
   the launches; (b) ``activation_parity_report`` of one forecaster forward
   (K1 and K3) per block against the SFNO oracle (2e-5 of each block's
   scale); (c) the native packer against numpy on a window of phase 18's
   shape, bit for bit, with both times; (d) ``Timers`` and ``timing_scope``
   around the window, ``trace_scope``'s Chrome trace naming K1 and K3,
   ``device_memory_stats`` against ``torch.cuda``; (e) ``save_orbax`` and
   ``restore_orbax`` (``torch.distributed.checkpoint``) of a DCP_EMBED x
   DCP_LAYERS SFNO's state on the card, bit for bit, with bytes and seconds.

22. the skill studies: (a) (run after phase 2, before any profiler pass,
   since a call at these shapes is mostly the host's work; ``phase22a``)
   K1's forward, dx and dW at the studies' shapes (CI = CO = 64 and 16)
   against their plain versions with their ms, the plain version's and
   complex ``torch.matmul``'s, and dW through its wrapper at 1, 3, 9 and the
   plan's splits; (b)-(d) (run after phase 20, before the profile;
   ``phase22``) the port's ``skill_proof`` and
   ``ace_skill --configs dense`` at the full preset's widths with their
   depth cut, ``tests/test_skill.py``'s gates on the report, and K1's
   forwards, dx, dW and weight images in every training step, counted by a
   hook on ``Trainer.train_step``.
23. float16 (run after phase 22, before the profile; ``phase23``): (a) the
   float16 instances of K2 (the forecaster's call with the float32 residual,
   float16 out, a float16 residual, erf gelu, the interpolator's 129,600 rows
   with dropout 0.1), K3 (batch 1 with the float32 residual, batch 2, 77
   rows a sample with dropout) and K4 (the fast window's shape, batch 1 and
   2) against their plain versions (F16_TOL, the dropout masks bit for bit)
   with their ms beside their bf16 instances', bounds and the float16
   ``torch.matmul``/``torch.bmm`` chains' ms; (b) the window path (K1 + K2),
   the fused-tail path (K1 + K3) and ``main_path.FAST_WINDOW_F16`` (K4) at
   ``dtype="float16"``, one counted 12-step window each with dropout live,
   the launches as their bf16 paths'; (c) each with dropout off against the
   float32 plain path from the same weights: its error at most
   F16_WINDOW_VS_PLAIN times the float16 plain path's own.
24. the port's ``scripts/rollout_10yr.py`` (``phase24``) at 256 x 8 on 180 x
   360, horizon 6, in ROLLOUT10_VARIANTS (the JAX script's program, plain
   bf16; ``--use-pallas --fused-tail`` in bf16 and in float16 with float16
   predictions; ``--fast`` in bf16 through K4 and in float16 unfused), each
   cut from 14,600 steps to ROLLOUT10_STEPS (two windows of 48) after its
   warm-up window: steps/s, sim-yr/day, the host fractions,
   ``all_steps_finite`` and the time-mean logs finite, the kernels'
   launches a forward.
25. the port's ``scripts/mesh_paper_window.py`` (``phase25``, after phase
   24, before the profile): every rank of the paper window (MPW_EMBED x
   MPW_LAYERS on MPW_SHAPE, MPW_STEPS steps, B = data rows of zeros) split
   over data x h x w, played in turn by this process over PyTorch's fake
   process group (no collective moves data, so no value is checked): (a)
   JAX's program (float32, plain, uniform sampler) at data 2 x h 2 x w 2;
   (b) phase 7's fused-tail path (K1, K3, bf16) at data 2 x h 2 x w 2 and
   data 1 x h 2 x w 2 (the four-card layout), K1 and K3 launched on every
   rank as on the one-card window; each rank's argument, output and temp
   MB, its seconds beside phase 7's, its collectives; (c) K1 and K3 at the
   four-card layout's rank 0 shapes against their plain versions.

It prints a ``training`` JSON line (phase 11's figures), a ``cli`` JSON line
(phase 12's), an ``options`` JSON line (phase 13's), a ``modes`` JSON line
(phase 14's), an ``ace`` JSON line (phase 15's), a ``unet`` JSON line
(phase 16's), a ``parallel`` JSON line (phase 17's), a ``spatial`` JSON
line (phase 21's), a ``studies`` JSON line (phase 22's), a ``data`` JSON line
(phase 18's), a ``writers`` JSON line (phase 10's writer run and phase
19's), a ``parity`` JSON line (phase 20's), a ``float16`` JSON line (phase
23's), a ``rollout_10yr`` JSON line (phase 24's), a ``mesh_paper_window``
JSON line (phase 25's), a ``kernels`` JSON
line (K1's backward dx as its own entry; the float16 instances of K2, K3 and
K4 as entries of their own, their launches those of phase 23's float16
paths ``"f16_window"``, ``"f16_fused_tail"`` and ``"f16_fast"`` and of phase
24's float16 variants; ``launches_by_path`` holds phase
12 (b)'s counts as ``"cli"``, phase 13's as ``"tucker"``, ``"fold"`` and
``"remat"``, phase 15's as ``"ace"``, ``"ace_cli"`` and
``"simultaneous"``, phase 16's as ``"unet"`` (zero for every kernel) and
phase 17's as ``"parallel"``, phase 21's as ``"spatial"``,
``"spatial_fast"``, ``"spatial_fold"`` and ``"spatial_unet"``, phase 18's
as ``"data_train"`` and
``"data"``, phase 19's as ``"outputs"`` and ``"outputs_ace"``, phase 20's
as ``"parity"`` and ``"parity_k2"``, phase 22's as ``"skill_proof"`` and
``"ace_skill"``, phase 23's as ``"f16_window"``, ``"f16_fused_tail"`` and
``"f16_fast"``, phase 24's as ``"rollout_10yr <variant>"``, phase 15's
float16 and slab runs as ``"simultaneous f16"``, ``"ace f16"`` and ``"ace
slab"``, phase 25's as ``"mesh_paper_window <program> <layout>"``, the
launches of all of a layout's ranks; the dx and dW
entries' ``launches`` add phase 22's), the
``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero and prints no result. It needs the port's package beside it
and a CUDA card; without either it exits non-zero at once.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

F32_PEAK = 67e12  # FLOP/s, float32 outside the tensor cores (H100 SXM data sheet)
TF32_PEAK = 495e12  # FLOP/s, dense TF32 tensor cores
BF16_PEAK = 989e12  # FLOP/s, dense bf16 tensor cores
HBM_RATE = 3.35e12  # bytes/s
N_STEPS = 12
STEPS_PER_SIM_YEAR = 1460  # 6-hour steps
TRAIN_STEPS = 6  # per experiment in phase 11
CMP_STEPS = 3  # per experiment, kernels against the plain path, in phase 11 (c)
SPIN_CYCLES = 200_000_000  # about 0.1 s of torch.cuda._sleep at the H100's clocks
ROLLOUT_STEPS, ROLLOUT_WINDOW = 288, 96
CLI_STEPS = 24  # the inference command line's rollout in phase 12, in windows of 12
REF_STEPS = 12  # the reference checkpoint's window in phase 12
# phase 13: width, depth and grid of the option runs; the diagonal filter's
# width (at 256 its weight, 256 x 256 x 180 x 181 pairs, is 17.1 GB a block)
OPT_EMBED, OPT_LAYERS, OPT_SHAPE = 256, 8, (180, 360)
OPT_DIAG_EMBED = 64
REMAT_STEPS = 6  # per experiment in phase 13 (c)
REMAT_CMP_STEPS = 3  # per experiment, remat against no remat, in phase 13 (c)
# what the earlier phases may leave allocated when phase 13 (c) starts (the
# window inputs, about 20 MB, and small caches): its peak is read as the
# trainers' own
REMAT_LIVE_GB = 0.1
# phase 14: width, depth and grid of the training modes; steps of the bf16
# runs (c, d), of the fused epoch and the streamed one (a, b, batch 1), the
# streaming segment, the rollout validation's steps (e: two horizon-6
# windows) and the steps of the histogram fits (f)
MODES_EMBED, MODES_LAYERS, MODES_SHAPE = 256, 8, (180, 360)
MODES_STEPS, FUSED_STEPS, SEGMENT_SAMPLES = 3, 8, 4
ROLLOUT_VAL_STEPS, HIST_STEPS = 12, 4
# phase 14 (c): a bf16-compute step against the float32 step from the same
# weights and batch. The losses' relative gap was 4.8e-6 (forecaster) and
# 6.9e-6 (interpolator) at 256 x 8 on the H100 (this script's phase 14,
# PERF.md): held to BF16_VS_F32_LOSS. The gradient norms (before clipping)
# must differ by more than BF16_GRAD_NORM_FLOOR (relative), as the CPU test
# (tests/test_torch_port_train_modes.py, F32_VS_BF16) holds the bf16
# gradients apart from the float32 ones: a step that computed in float32
# through the same kernels repeats the norm up to the order of its float32
# sums (about 1e-7), so the floor shows that the bf16 path ran.
BF16_VS_F32_LOSS = 5e-5
BF16_GRAD_NORM_FLOOR = 1e-5
# The fused-tail window in bf16 against the plain path in bf16, as a
# multiple of the plain path's own bf16 error (bf16 against float32): the
# fused tail rounds the folded norm input to bf16 once more. The CPU test
# (tests/test_torch_port_tail.py, BF16_TAIL_VS_PLAIN) measured a ratio of
# 0.76 at debug size and holds it to 2; a ratio scales with width and depth
# where an absolute gap does not.
BF16_TAIL_VS_PLAIN = 2.0
# phase 15: width, depth, grid, water levels and other prognostics of the
# ACE runs (bench.py:ace_bench's), the rollout's steps and window, and the
# simultaneous training's warm-up, timed and compared steps
ACE_EMBED, ACE_LAYERS, ACE_SHAPE = 256, 8, (180, 360)
ACE_LEVELS, ACE_OTHER = 8, 25
ACE_STEPS, ACE_WINDOW = 48, 12
SIM_WARMUP, SIM_STEPS, SIM_CMP_STEPS = 2, 3, 3
# phase 16: the UNet of configs/model/unet.json (its width, multipliers and
# resampled grid), the main path's state channels, the forwards timed a
# network and the training steps an experiment
UNET_DIM, UNET_MULTS = 64, (1, 2, 4, 8)
UNET_SHAPE, UNET_UPSAMPLE = (180, 360), (184, 368)
UNET_STATE, UNET_REPS, UNET_TRAIN_STEPS = 35, 5, 3
# phase 17: the transforms' channels and grid, and the SFNO trained through K1
PAR_CHANNELS, PAR_SHAPE = 256, (180, 360)
PAR_EMBED, PAR_LAYERS, PAR_STEPS = 256, 8, 3
# phase 21: spatial model parallelism at the main path's width, depth and
# grid: K1 and K4 on the channel shards of "w" = 2 and 4 (CI = embed / 2 and
# / 4; 2R / 2 and / 4), K4 on the rows of an "h" = 2 block, K2 and K3 on the
# blocks of h = 2, w = 2 and of h = 2 at batch 2 (the interpolator's double
# batch), the fused-tail and fast windows and each filter option on the
# spatial route
SPATIAL_EMBED, SPATIAL_LAYERS, SPATIAL_SHAPE = 256, 8, (180, 360)
# phase 18: the networks' width and depth and the dataset's grid
DATA_EMBED, DATA_LAYERS, DATA_SHAPE = 256, 8, (180, 360)
# phase 19: the networks' width, depth and grid, the ensemble and the time
# coarsening of the output files
OUT_EMBED, OUT_LAYERS, OUT_SHAPE = 256, 8, (180, 360)
OUT_ENSEMBLE, OUT_COARSEN = 2, 4
# phase 20: the parity checkpoints' width, depth, grid and horizon, the
# window's steps (the float64 oracle takes about 33 s of host time an SFNO
# forward at 64 x 2 on 180 x 360, so two horizon-2 passes), the longest wait
# for the oracle's process, and the SFNO whose state DCP saves
PARITY_EMBED, PARITY_LAYERS, PARITY_SHAPE = 64, 2, (180, 360)
PARITY_HORIZON, PARITY_STEPS, ORACLE_WAIT_S = 2, 3, 900
DCP_EMBED, DCP_LAYERS = 256, 8
# the model overrides of phase 20's two windows: the reference checkpoint
# loader turns exact_dropout on, which keeps the MLP off K2 and K3 (they
# quantize the dropout rate); with the interpolator's dropout off the
# windows draw no dropout, so turning it off only routes the MLP through them
# phase 22: the skill studies at the full preset's widths, their depth cut
# (the preset's 24 + 24 epochs and 504 rollout steps, ace_skill's 24 epochs),
# and the gates of tests/test_skill.py on skill_proof's report: the
# interpolator's val RMSE under 0.6 x climatology, its train loss down 20%
# (last epoch's mean under 0.8 x the first's), h1 RMSE under 0.8 x
# climatology, cold sampling's CRPS at the last horizon at most 1.05 x naive
# sampling's
SKILL_PRESET = "full"
SKILL_EPOCHS_INTERP, SKILL_EPOCHS_FC, SKILL_ROLLOUT, ACE_SKILL_EPOCHS = 3, 2, 72, 2
# the training frames of both studies (the preset's 8192): the stacked
# 7-frame windows of 8192 frames are 3.8 GB, read on the host in about 30 s
# a stage on the card's machine
SKILL_N_TIMESTEPS = 2048
SKILL_INTERP_VS_CLIM, SKILL_LOSS_DROP, SKILL_H1_VS_CLIM, SKILL_COLD_VS_NAIVE = 0.6, 0.8, 0.8, 1.05
PARITY_K3 = {"use_pallas": True, "fused_tail": True, "exact_dropout": False}
PARITY_K2 = {"use_pallas": True, "fused_mlp": True, "exact_dropout": False}
# phase 23: the float16 instances of K2, K3 and K4 against their plain
# versions, relative to the largest output: a float16 intermediate may round
# a tie the other way in the two versions, one step of 2^-11 of it carried
# through a product (bf16's 1e-2 is for steps of 2^-8); the float16 windows
# against the float32 plain path, as a multiple of the float16 plain path's
# own error (as BF16_TAIL_VS_PLAIN holds the bf16 windows)
F16_TOL = 2e-3
F16_WINDOW_VS_PLAIN = 2.0
F16_EMBED, F16_LAYERS, F16_SHAPE = 256, 8, (180, 360)
# phase 24: the port's rollout_10yr at 256 x 8, 14,600 steps cut to two
# windows of 48 after the warm-up window (the script's windows are 96; cut
# to 48 to keep the whole run inside its time limit), in the variants below
# with the
# launches each kernel must make an SFNO forward (12 forwards every 6 steps
# at horizon 6; --fast: K4 in blocks 1-6; --fast --dtype float16 runs the
# unfused rank pipeline, as JAX's SFNO)
ROLLOUT10_STEPS, ROLLOUT10_WINDOW = 96, 48
ROLLOUT10_EMBED, ROLLOUT10_LAYERS = 256, 8
# phase 25: the port's mesh_paper_window at the paper window's width, depth,
# grid and steps, each rank of the split window in turn over the fake process
# group; the SFNO forwards of the peeled sampler's 12-step window at horizon 6
# (the one-card count where phase 7 did not run)
MPW_EMBED, MPW_LAYERS, MPW_SHAPE, MPW_STEPS = 256, 8, (180, 360), 12
MPW_FORWARDS = 24
ROLLOUT10_VARIANTS = {
    "plain bf16": ([], {"K1": 0, "K2": 0, "K3": 0, "K4": 0}),
    "K1+K3 bf16": (["--use-pallas", "--fused-tail"], {"K1": 8, "K2": 0, "K3": 8, "K4": 0}),
    "K1+K3 float16": (["--use-pallas", "--fused-tail", "--dtype", "float16", "--preds-dtype",
                       "float16"], {"K1": 8, "K2": 0, "K3": 8, "K4": 0}),
    "fast bf16": (["--fast"], {"K1": 0, "K2": 0, "K3": 0, "K4": 6}),
    "fast float16": (["--fast", "--dtype", "float16"], {"K1": 0, "K2": 0, "K3": 0, "K4": 0}),
}


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        log(f"== phase {self.name}")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"== phase {self.name}: {time.perf_counter() - self.t0:.2f} s")
        return False


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def bound(flops: float, nbytes: float, peak: float):
    t_ops, t_bytes = flops / peak, nbytes / HBM_RATE
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def dw_plan(x, gy) -> dict:
    """``wgrad_plan`` of dW's kernel for x ``(..., L, M, CI, 2)`` and g
    ``(..., L, M, CO, 2)``: its splits, chunks a split, promotion interval,
    co a block, blocks and workspace MB."""
    from spherical_dyffusion_tpu_torch.ops.pallas_contractions import wgrad_plan

    L, M, CI = x.shape[-4:-1]
    p = wgrad_plan(x.numel() // (L * M * CI * 2), L, M, CI, gy.shape[-2])
    return dict(splits=p.splits, per_split=p.per_split, promote=p.promote,
                co_tile=p.co_tile, blocks=p.blocks, workspace_mb=p.workspace * 4 / 1e6)


def dw_plan_text(p: dict) -> str:
    return (f"plan {p['splits']} split(s) of {p['per_split']} chunks, {p['blocks']} blocks of "
            f"64 ci x {p['co_tile']} co, workspace {p['workspace_mb']:.2f} MB")


def dw_by_plan(x, gy, want, plans, timed_ms) -> dict:
    """dW through its wrapper at x ``(B, L, M, C, 2)``, g alike, under each
    of ``plans`` (``wgrad_plan``'s keywords, such as ``splits``, in place
    of the plan's own choice while it is timed): per plan the ms a
    call in a loop of 200 calls and the device ms (queued behind a spin),
    each result held to 1e-5 of ``want``'s largest entry."""
    from spherical_dyffusion_tpu_torch.ops import pallas_contractions as pc

    plan, ms = pc.wgrad_plan, {}
    call = lambda: pc.dhconv_weight_grad(x, gy)  # noqa: E731
    try:
        for kw in plans:
            key = ",".join(f"{k}={v}" for k, v in kw.items())
            pc.wgrad_plan = lambda *a, kw=kw: plan(*a, **kw)
            got = call()
            err = float((got - want).abs().max() / want.abs().max())
            check(err <= 1e-5, f"dW at {key} disagrees with its plain version ({err:.3e})")
            ms[key] = dict(ms=timed_ms(call, 200), device_ms=timed_ms(call, 20, spin=True))
    finally:
        pc.wgrad_plan = plan
    return ms


def k4_library(xf, A, S, C):
    """K4's yardstick: the bf16 (or float32) torch.bmm chain, batched over
    m, with the float32 CP scale between the two products and the layout
    permutes to and from the port's layout; S may hold a block's rows."""
    import torch

    B, H, M, R2, _ = xf.shape
    R, L, Ho = R2 // 2, A.shape[2], S.shape[1]
    xm = xf.permute(2, 1, 0, 3, 4).reshape(M, H, B * R2 * 2)
    t = torch.bmm(A.transpose(1, 2), xm).view(M, L, B, R2, 2).float()
    Sr, Si = t[..., :R, :], t[..., R:, :]
    p_re, p_im = Sr[..., 0] - Si[..., 1], Sr[..., 1] + Si[..., 0]
    Cr, Ci = C[:, None, :, 0], C[:, None, :, 1]
    s_re, s_im = p_re * Cr - p_im * Ci, p_re * Ci + p_im * Cr
    s = torch.cat([torch.stack([s_re, s_im], -1), torch.stack([-s_im, s_re], -1)], -2)
    y = torch.bmm(S, s.to(xf.dtype).reshape(M, L, B * R2 * 2))
    return y.view(M, Ho, B, R2, 2).permute(2, 1, 0, 3, 4).contiguous()


def k4_bound(xf, A, S, C, l_first, dense=False):
    """K4's bound over what these inputs need: the rows l >= l_first[m] of
    A[m] and S[m] (the triangle; dense=True: all of them), xf read and y
    (S's rows) written once, C."""
    B, H, M, R2, _ = xf.shape
    L, Ho = A.shape[2], S.shape[1]
    rows = M * L if dense else int((L - l_first.clamp(0, L)).sum())
    flops = 2.0 * rows * 2 * R2 * B * (H + Ho)
    nbytes = xf.element_size() * (xf.numel() + B * Ho * M * R2 * 2 + (H + Ho) * rows) + \
        4.0 * C.numel()
    return bound(flops, nbytes, BF16_PEAK if xf.element_size() == 2 else F32_PEAK)


def host_to_device():
    """A dispatch mode recording ``(op, bytes)`` for every host tensor that
    an aten op reads into a result on a CUDA device: ``.to``/``copy_`` from
    the host, a host tensor in an op on the card, and a tensor constructor
    (``torch.tensor``/``as_tensor``, its ``lift_fresh``) whose result is on
    the card (counted whole: its data may come from the host). Every op
    dispatched while it is on passes through it, the backward's too, so
    unlike a profiler trace it drops no record. Use as
    ``with host_to_device() as seen: ...``, then read ``seen.copies``."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class HostToDevice(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.copies = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            ins = [a for a in tree_leaves((args, kwargs)) if isinstance(a, torch.Tensor)]
            if any(isinstance(o, torch.Tensor) and o.is_cuda for o in tree_leaves(out)):
                fresh = func is torch.ops.aten.lift_fresh.default
                for a in ins:
                    if fresh or a.device.type == "cpu":
                        self.copies.append((str(func), a.numel() * a.element_size()))
            return out

    return HostToDevice()


def live_cuda_tensors(top: int = 10):
    """The CUDA storages that Python objects keep alive: (their bytes, the
    ``top`` largest as (GB, shape, dtype))."""
    import gc

    import torch

    seen = {}
    for o in gc.get_objects():
        if isinstance(o, torch.Tensor) and o.is_cuda:
            st = o.untyped_storage()
            seen.setdefault(st.data_ptr(), (st.nbytes() / 1e9, tuple(o.shape), str(o.dtype)))
    return (sum(v[0] for v in seen.values()) * 1e9,
            sorted(seen.values(), key=lambda v: -v[0])[:top])


def ace_native_state(stepper, img_shape) -> dict:
    """The stepper state of a native ACE checkpoint of ``stepper``: its
    network in the reference's names and only the reference builder's keys
    (phases 15 (d) and 19)."""
    import torch

    from spherical_dyffusion_tpu_torch.utils.convert import state_dict_to_flax
    from spherical_dyffusion_tpu_torch.utils.torch_convert import sfno_flax_to_torch

    m = stepper.module
    state = stepper.get_state()
    state["config"].update(
        loss={"type": "MSE"},
        builder={"type": "SphericalFourierNeuralOperatorNet",
                 "config": {"embed_dim": m.cfg.embed_dim, "num_layers": m.cfg.num_layers,
                            "operator_type": "dhconv", "scale_factor": 1,
                            "data_grid": "equiangular"}})
    state["module"] = {k: torch.from_numpy(v) for k, v in
                       sfno_flax_to_torch(state_dict_to_flax(m.state_dict())).items()}
    state["img_shape"] = tuple(img_shape)
    return state


def phase10_writer(smi_line, wrappers, report, stepper, zero_counts, off,
                   device="cuda") -> None:
    """Phase 10's second run: the product rollout with the prediction writer,
    as ``bench.py:product_bench`` times it by default, on the stepper and
    seed of the run without it (``off``: its summary and logs), into a
    temporary directory that is removed afterwards. The timed run goes under
    the sync debug mode "error"; its logs must equal the run without the
    writer bit for bit, K1 and K3 launch 1,536 times a window, and
    ``run_dataset_inference`` over the written file gives the rollout's own
    per-step logs (1e-6)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from spherical_dyffusion_tpu_torch import main_path
    from spherical_dyffusion_tpu_torch.data.datasets import SyntheticTimeSeries
    from spherical_dyffusion_tpu_torch.evaluation.aggregators import InferenceAggregator
    from spherical_dyffusion_tpu_torch.inference.loop import run_dataset_inference
    from spherical_dyffusion_tpu_torch.inference.writers import DataWriter

    exp = stepper.exp
    names = list(exp.out_packer.names)
    H, W = exp.model.cfg.img_shape
    # the product source, as product_rollout makes it, looped without end
    src = SyntheticTimeSeries(list(exp.in_packer.names) + list(exp.forcing_names)
                              + [main_path.MASK_NAME], n_timesteps=ROLLOUT_WINDOW,
                              spatial_shape=(H, W))

    frames = src.read_window(0, ROLLOUT_WINDOW, names)  # made once, then indexed

    class Looped:
        def read_window(self, start, length, wanted):
            at = np.arange(start, start + length) % ROLLOUT_WINDOW
            return {n: frames[n][at] for n in wanted}

    wdir = tempfile.mkdtemp(prefix="chip_smoke_writer_")
    try:
        free_gb = shutil.disk_usage(wdir).free / 1e9
        expect = ROLLOUT_STEPS * len(names) * H * W * 4
        log(f"writer run: temporary directory on a file system with {free_gb:.1f} GB free; "
            f"{ROLLOUT_STEPS} steps x {len(names)} fields x {H * W * 4} B = {expect / 1e9:.3f} GB "
            "to write")
        check(free_gb * 1e9 > 2 * expect, f"writer run: {free_gb:.1f} GB free")
        append_s = [0.0]
        real_append = DataWriter.append

        def timed_append(self, *a, **k):
            t0 = time.perf_counter()
            real_append(self, *a, **k)
            append_s[0] += time.perf_counter() - t0

        def before_timed():
            zero_counts()
            if device == "cuda":
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")

        DataWriter.append = timed_append
        try:
            t0 = time.perf_counter()
            summary, agg = main_path.product_rollout(stepper, n_steps=ROLLOUT_STEPS,
                                                     window=ROLLOUT_WINDOW,
                                                     before_timed=before_timed, writer_dir=wdir)
            wall = time.perf_counter() - t0
        finally:
            if device == "cuda":
                torch.cuda.set_sync_debug_mode(0)
            DataWriter.append = real_append
        launches = {k: fn.launches for k, fn in wrappers.items()}
        n_windows = ROLLOUT_STEPS // ROLLOUT_WINDOW
        for k, n in (("K1", 1536), ("K2", 0), ("K3", 1536), ("K4", 0)):
            check(launches[k] == n * n_windows,
                  f"writer run: {k} launched {launches[k]} times in {n_windows} windows, expected "
                  f"{n} a window")
        logs = agg.get_logs()
        same = logs == off["logs"]
        nbytes = summary["writer_bytes"]
        check(nbytes >= expect, f"writer run: {nbytes} bytes written, expected {expect} or more")
        rates = {}
        for label, s in (("without the writer", off["summary"]), ("with the writer", summary)):
            steady = s["steady_steps_per_second"]
            rates[label] = steady
            log(f"rollout {label}: {ROLLOUT_STEPS} steps in {n_windows} windows of "
                f"{ROLLOUT_WINDOW}: duration {s['duration_s']:.3f} s, total "
                f"{s['total_steps_per_second']:.3f} steps/s, steady {steady:.3f} steps/s = "
                f"{steady * 86400 / STEPS_PER_SIM_YEAR:.1f} sim-yr/day; "
                + ", ".join(f"{k} {v:.3f} s" for k, v in s.items() if k.startswith("time/"))
                + f"; on {smi_line}")
        log(f"writer: {nbytes / 1e9:.3f} GB written (autoregressive_predictions.nc), appends "
            f"{append_s[0]:.3f} s = {nbytes / 1e6 / append_s[0]:.0f} MB/s (the drain's event wait "
            f"and the host's bf16 widening are outside the appends), close (the chunk index and "
            f"the headers) {summary['writer_close_s']:.3f} s; steady rate with the writer "
            f"{rates['with the writer'] / rates['without the writer']:.2%} of the rate without; "
            f"the timed run under the sync debug mode 'error' with one event wait a window (the "
            f"mode does not count it); logs {'equal bit for bit' if same else 'differ'} to the run "
            f"without the writer ({len(logs)} logs); launches {launches}; {wall:.2f} s with the "
            f"warm-up window")
        check(same, "writer run: the aggregator's logs differ from the run without the writer")
        # the written file, re-scored against the looped source
        ds_agg = InferenceAggregator(names, src.horizontal.area_weights(),
                                     log_zonal_mean_images=False)
        t0 = time.perf_counter()
        run_dataset_inference(os.path.join(wdir, "autoregressive_predictions.nc"), Looped(), names,
                              src.horizontal.area_weights(), aggregator=ds_agg, device=device)
        rescore_s = time.perf_counter() - t0
        want, got = agg.get_inference_logs(), ds_agg.get_inference_logs()
        check(len(want) == len(got) == ROLLOUT_STEPS and all(set(a) == set(b)
                                                              for a, b in zip(want, got)),
              f"re-scoring: {len(got)} steps of logs against {len(want)}")
        rel = max(abs(b[k] - v) / max(abs(v), 1.0) for a, b in zip(want, got) for k, v in a.items())
        log(f"run_dataset_inference over the written file ({ROLLOUT_STEPS} steps read back through "
            f"data/hdf5.py, {rescore_s:.2f} s): per-step logs against the rollout's own, max gap "
            f"{rel:.3e} (tolerance 1e-6)")
        check(rel <= 1e-6, "run_dataset_inference over the written file differs from the rollout")
    finally:
        shutil.rmtree(wdir, ignore_errors=True)
    report.setdefault("writers", {})["product"] = {
        "without": {k: off["summary"][k] for k in (
            "duration_s", "total_steps_per_second", "steady_steps_per_second",
            "time/writer_and_aggregator", "time/run_on_batch", "time/data_loading")},
        "with": {k: summary[k] for k in (
            "duration_s", "total_steps_per_second", "steady_steps_per_second",
            "time/writer_and_aggregator", "time/run_on_batch", "time/data_loading",
            "writer_close_s", "writer_bytes")},
        "append_s": append_s[0], "mb_per_s": nbytes / 1e6 / append_s[0],
        "rescore_s": rescore_s, "rescore_max_rel": rel, "logs_bit_equal": same,
        "launches": launches}


def phase12(smi_line, wrappers, report, runs) -> None:
    """Phase 12: the product path from checkpoint files at 256 x 8 on 180 x
    360, in a temporary directory: (a) the train command line, (b) the
    inference command line from its checkpoint, (c) a reference Lightning
    checkpoint built from (a)'s networks, (d) the trained CP forecaster of
    ``results/skill_fast08`` decoded without flax."""
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from spherical_dyffusion_tpu_torch import interface, main_path
    from spherical_dyffusion_tpu_torch.inference.stepper import DYffusionStepper
    from spherical_dyffusion_tpu_torch.models.sfno import SFNO, SFNOConfig
    from spherical_dyffusion_tpu_torch.ops.pallas_contractions import dhconv
    from spherical_dyffusion_tpu_torch.run_inference import main_from_config
    from spherical_dyffusion_tpu_torch.train import run_model
    from spherical_dyffusion_tpu_torch.training.trainer import Trainer
    from spherical_dyffusion_tpu_torch.utils import flax_msgpack
    from spherical_dyffusion_tpu_torch.utils.convert import flax_to_state_dict, state_dict_to_flax
    from spherical_dyffusion_tpu_torch.utils.torch_convert import sfno_flax_to_torch

    cli = {}
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_cli_")
    d = Path(tmp.name)

    def equal_sd(got, want):
        return set(got) == set(want) and all(torch.equal(got[k].cpu(), want[k].cpu())
                                             for k in want)

    def zero_counts():
        for fn in wrappers.values():
            fn.launches = 0

    # (a) the train command line: the interpolator, then the forecaster,
    # two steps each; every step timed (synchronized) with its K1 launches,
    # those of the backward (dx) apart, and every checkpoint write timed
    common = [f"ckpt_dir={d}", f"++log_dir={d / 'logs'}", "trainer.epochs=1",
              "++trainer.steps_per_epoch=2", "datamodule.n_timesteps=8",
              "datamodule.height=180", "datamodule.width=360", "datamodule.channels=35",
              "datamodule.n_forcing=2", "datamodule.batch_size=1",
              "++datamodule.max_val_samples=1", "++trainer.num_predictions=2",
              "model.embed_dim=256", "model.num_layers=8", "++model.use_pallas=true",
              "verbose=false"]
    steps, writes = [], []
    real_step, real_save, real_grad = Trainer.train_step, Trainer.save_checkpoint, \
        torch.autograd.grad
    backward = [0]

    def timed_step(self, *a, **k):
        torch.cuda.synchronize()
        n0, b0, t0 = dhconv.launches, backward[0], time.perf_counter()
        out = real_step(self, *a, **k)
        torch.cuda.synchronize()
        steps.append(dict(exp=type(self.exp).__name__, ms=(time.perf_counter() - t0) * 1e3,
                          k1=dhconv.launches - n0, k1_backward=backward[0] - b0))
        return out

    def counted_grad(*a, **k):
        n0 = dhconv.launches
        out = real_grad(*a, **k)
        backward[0] += dhconv.launches - n0
        return out

    def timed_save(self, state, path):
        t0 = time.perf_counter()
        real_save(self, state, path)
        writes.append(dict(path=path, seconds=time.perf_counter() - t0,
                           bytes=os.path.getsize(path)))

    Trainer.train_step, Trainer.save_checkpoint = timed_step, timed_save
    torch.autograd.grad = counted_grad
    try:
        zero_counts()
        t0 = time.perf_counter()
        ip = run_model(None, ["experiment=debug_interpolation"] + common)
        fc = run_model(None, ["experiment=debug_dyffusion",
                              f"diffusion.interpolator_checkpoint_path={ip['ckpt_path']}"]
                       + common)
        train_s = time.perf_counter() - t0
    finally:
        Trainer.train_step, Trainer.save_checkpoint = real_step, real_save
        torch.autograd.grad = real_grad
    off = {k: wrappers[k].launches for k in ("K2", "K3", "K4")}
    check(not any(off.values()), f"train command line launched kernels without a backward: {off}")
    per_step = {"InterpolationExperiment": (16, 8), "DYffusionForecastingExperiment": (24, 8)}
    for s in steps:
        check((s["k1"], s["k1_backward"]) == per_step[s["exp"]],
              f"train command line {s['exp']}: K1 launches {s['k1']} (backward "
              f"{s['k1_backward']}) a step, expected {per_step[s['exp']]} as in phase 11")
    check([s["exp"] for s in steps] == ["InterpolationExperiment"] * 2
          + ["DYffusionForecastingExperiment"] * 2, f"train command line steps {steps}")
    for name, run in (("interpolator", ip), ("forecaster", fc)):
        check(all(np.isfinite(run["history"]["step_losses"])), f"{name}: a non-finite loss")
        path = run["ckpt_path"]
        write = [w for w in writes if w["path"] == path][-1]
        t0 = time.perf_counter()
        Trainer.load_checkpoint(path)
        read_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        exp, params, ema, _ = interface.load_experiment_checkpoint(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        state = run["trainer"].state
        same = (equal_sd(params, state.model.state_dict())
                and equal_sd(exp.model.state_dict(), state.model.state_dict())
                and equal_sd(ema, state.ema.state_dict()))
        check(same, f"{name}: the reloaded parameters or EMA differ from the trainer's")
        ms = [s["ms"] for s in steps if (s["exp"] == "InterpolationExperiment") ==
              (name == "interpolator")]
        cli[name] = dict(step_ms=ms, losses=run["history"]["step_losses"],
                         ckpt_bytes=write["bytes"], write_s=write["seconds"], read_s=read_s,
                         load_experiment_s=load_s)
        log(f"train command line {name}: step ms {[round(v, 2) for v in ms]} (synchronized "
            f"around each step; phase 11's median "
            f"{report['training'][name]['step_ms']:.2f} ms), losses "
            f"{[round(v, 5) for v in run['history']['step_losses']]}; checkpoint "
            f"{write['bytes'] / 1e9:.3f} GB written in {write['seconds']:.2f} s, read "
            f"(torch.load) in {read_s:.2f} s, load_experiment_checkpoint {load_s:.2f} s; "
            f"params and EMA reload bit for bit; on {smi_line}")
        del exp, params, ema
    log(f"train command line: both experiments built, trained and saved in {train_s:.2f} s; "
        f"K1 launches a step {[s['k1'] for s in steps]} (backward "
        f"{[s['k1_backward'] for s in steps]})")
    fc_exp, fc_ema = fc["trainer"].exp, fc["trainer"].state.ema.state_dict()
    del ip
    torch.cuda.empty_cache()

    # (b) the inference command line from the forecaster's checkpoint (and,
    # through its config, the interpolator's): K1 and K3 in both networks,
    # bf16 compute and transforms, the EMA
    forwards = []
    real_forward = SFNO.forward

    def counted_forward(self, *a, **k):
        forwards.append(a[0].shape[0])
        return real_forward(self, *a, **k)

    def infer(model, out, **extra):
        over = {"model": model, "interpolator_model": model, **extra}
        return main_from_config({"checkpoint_path": fc["ckpt_path"], "use_ema": True,
                                 "n_forward_steps": CLI_STEPS, "forward_steps_in_memory": 12,
                                 "experiment_dir": str(d / out), "log_zonal_mean_images": False,
                                 "verbose": False, "overrides": over})

    bf16 = dict(use_pallas=True, fused_tail=True, compute_dtype="bfloat16",
                sht_matmul_dtype="bfloat16")
    zero_counts()
    SFNO.forward = counted_forward
    try:
        t0 = time.perf_counter()
        out = infer(bf16, "bf16")
        wall = time.perf_counter() - t0
    finally:
        SFNO.forward = real_forward
    launches = {k: fn.launches for k, fn in wrappers.items()}
    runs["cli"] = dict(launches=launches)
    summary = out["summary"]
    log(f"inference command line, {CLI_STEPS} steps in windows of 12 from the checkpoint, bf16, "
        f"K1 and K3, EMA: {wall:.2f} s with loading; duration {summary['duration_s']:.3f} s, "
        f"total {summary['total_steps_per_second']:.3f} steps/s, steady "
        f"{summary['steady_steps_per_second']:.3f} steps/s (phase 7's fused-tail window is "
        f"printed below); SFNO forwards {len(forwards)}, launches {launches}; on {smi_line}")
    for k, n in (("K1", 8), ("K3", 8), ("K2", 0), ("K4", 0)):
        check(bool(forwards) and launches[k] == n * len(forwards),
              f"inference command line: {k} launched {launches[k]} times in {len(forwards)} "
              f"SFNO forwards, expected {n} a forward")
    metrics = json.loads((d / "bf16" / "metrics.json").read_text())
    logs = {k: v for k, v in metrics.items() if k.startswith("inference/")}
    bad = [k for k, v in logs.items() if not np.isfinite(v)]
    check(len(logs) > 20 and not bad and metrics["n_forward_steps"] == CLI_STEPS,
          f"inference command line metrics.json: {len(logs)} metrics, non-finite {bad[:4]}")
    cli["inference"] = dict(steps=CLI_STEPS, wall_s=wall, forwards=len(forwards),
                            launches=launches, **{k: summary[k] for k in (
                                "duration_s", "total_steps_per_second",
                                "steady_steps_per_second")})
    del out

    # float32, the interpolator's dropout off: through the kernels and
    # through the plain path, final states and logs
    finals = []
    real_window = DYffusionStepper.run_window

    def recorded(self, *a, **k):
        result = real_window(self, *a, **k)
        finals.append(result[0])
        return result

    det = {}
    DYffusionStepper.run_window = recorded
    try:
        for kernels in (True, False):
            finals.clear()
            model = dict(use_pallas=kernels, fused_tail=kernels)
            det[kernels] = (infer(model, f"f32_{kernels}", diffusion={
                "enable_interpolator_dropout": False})["logs"], finals[-1])
    finally:
        DYffusionStepper.run_window = real_window
    (lk, xk), (lp, xp) = det[True], det[False]
    state_rel = float((xk - xp).abs().max() / xp.abs().max())
    log_rel = max(abs(lk[k] - v) / max(abs(v), 100.0 if "percent_diff" in k else 1.0)
                  for k, v in lp.items())
    log(f"inference command line float32, dropout off, {CLI_STEPS} steps: kernels against the "
        f"plain path: final state max gap {state_rel:.3e} of its largest value, logs max gap "
        f"{log_rel:.3e} of each value (or of 1; tolerance 1e-4, phase 7's)")
    check(set(lk) == set(lp) and state_rel <= 1e-4 and log_rel <= 1e-4,
          "inference command line: the kernels disagree with the plain path")
    cli["inference"].update(f32_state_rel=state_rel, f32_logs_rel=log_rel)
    del det, finals, xk, xp
    torch.cuda.empty_cache()

    # (c) a reference Lightning checkpoint from (a)'s networks, through the
    # upstream names (sfno_flax_to_torch): the forecaster under model.model,
    # the interpolator under model.interpolator.model, LitEma shadows
    nets = {"model.model.": fc_exp.model.state_dict(),
            "model.interpolator.model.": fc_exp.interpolator.model.state_dict()}
    sd = {}
    for prefix, net in list(nets.items()) + [("model_ema.", fc_ema)]:
        for k, v in sfno_flax_to_torch(state_dict_to_flax(net), mlp_dropout=True).items():
            key = "model_ema." + ("model." + k).replace(".", "") if prefix == "model_ema." \
                else prefix + k
            sd[key] = torch.from_numpy(v)
    names = list(fc_exp.in_packer.names)
    forcings = list(fc_exp.forcing_names)
    check(len(names) == 35 and len(forcings) == 2, f"state {len(names)}, forcings {forcings}")
    hp = {"model_config": {"_target_": "src.models.sfno.sfnonet."
                                       "SphericalFourierNeuralOperatorNet",
                           "embed_dim": 256, "num_layers": 8, "dropout_mlp": 0.1,
                           "drop_path_rate": 0.1},
          "datamodule_config": {"_target_": "src.datamodules.fv3gfs.FV3GFSDataModule",
                                "in_names": names + forcings, "forcing_names": forcings,
                                "out_names": names, "horizon": 6, "window": 1},
          "diffusion_config": {"_target_": "src.diffusion.dyffusion.DYffusion",
                               "forward_conditioning": "none", "time_encoding": "dynamics"}}
    ref_path = str(d / "reference.ckpt")
    t0 = time.perf_counter()
    torch.save({"state_dict": sd, "hyper_parameters": hp, "epoch": 1}, ref_path)
    ref_write = time.perf_counter() - t0
    ref_bytes = os.path.getsize(ref_path)
    del sd
    t0 = time.perf_counter()
    exp, _, ema, cfg = interface.load_experiment_checkpoint(
        ref_path, overrides={"model": {"use_pallas": True}})
    torch.cuda.synchronize()
    ref_load = time.perf_counter() - t0
    mc = exp.model.cfg
    check((mc.activation_function, mc.exact_norm, mc.exact_dropout) ==
          ("gelu_exact", True, True) and exp.interpolator.model.cfg.exact_dropout,
          f"reference checkpoint: the model is not the exact-form one: {mc}")
    check(equal_sd(exp.model.state_dict(), nets["model.model."])
          and equal_sd(exp.interpolator.model.state_dict(), nets["model.interpolator.model."])
          and equal_sd(ema, fc_ema), "reference checkpoint: the weights differ")
    log(f"reference checkpoint: {ref_bytes / 1e9:.3f} GB written in {ref_write:.2f} s, loaded "
        f"in {ref_load:.2f} s (gelu_exact, exact_norm, exact_dropout), weights and EMA equal "
        f"bit for bit")
    inp = main_path.window_inputs(REF_STEPS, seed=5, device="cuda")
    stepper = DYffusionStepper(exp, use_ema_params=True, ema_params=ema)

    def ref_window(st, seed=0):
        out = st.run_window(inp["x0"], inp["forcing"], None, None,
                            torch.Generator().manual_seed(seed), REF_STEPS)
        torch.cuda.synchronize()
        return out

    ref_window(stepper)  # warm-up: K1's images, cuBLAS
    zero_counts()
    t0 = time.perf_counter()
    x_out, preds = ref_window(stepper, 1)
    ref_s = time.perf_counter() - t0
    ref_launches = {k: fn.launches for k, fn in wrappers.items()}
    check(ref_launches["K1"] > 0 and bool(torch.isfinite(preds).all()),
          f"reference checkpoint window: launches {ref_launches}, finite "
          f"{bool(torch.isfinite(preds).all())}")
    # exact dropout draws its uniforms on the card: count the bytes copied
    # from the host in one window under the dispatch mode, beside a 1 MiB
    # copy made on purpose in it (the mode has to see that one)
    act_bytes = 180 * 360 * 256 * 4
    control = torch.ones(1 << 18)
    with host_to_device() as seen:
        control.to("cuda")
        ref_window(stepper, 2)
    h2d = [b for _, b in seen.copies]
    h2d_bytes = sum(h2d) - control.numel() * 4
    log(f"reference checkpoint, {REF_STEPS} steps with the interpolator's exact dropout live "
        f"(K1 on): {ref_s:.3f} s, launches {ref_launches}; host-to-device in one window: "
        f"{len(h2d)} copies, {sum(h2d)} bytes, {h2d_bytes} besides the 1 MiB control "
        f"(one activation is {act_bytes} bytes)")
    check(h2d.count(control.numel() * 4) == 1,
          "the dispatch mode did not see the 1 MiB control copy once")
    check(h2d_bytes < act_bytes // 100,
          f"exact dropout: {h2d_bytes} bytes copied from the host in one window")
    del stepper, exp, x_out, preds
    torch.cuda.empty_cache()

    def ref_det(kernels):
        e, _, e_ema, _ = interface.load_experiment_checkpoint(ref_path, overrides={
            "model": {"use_pallas": kernels}, "diffusion": {"enable_interpolator_dropout": False}})
        return ref_window(DYffusionStepper(e, use_ema_params=True, ema_params=e_ema))[1]

    pk, pp = ref_det(True), ref_det(False)
    ref_rel = float((pk - pp).abs().max() / pp.abs().max())
    log(f"reference checkpoint float32, dropout off: kernels against the plain path max gap "
        f"{ref_rel:.3e} of the largest prediction (tolerance 1e-4)")
    check(ref_rel <= 1e-4, "reference checkpoint: the kernels disagree with the plain path")
    cli["reference"] = dict(bytes=ref_bytes, write_s=ref_write, load_s=ref_load,
                            window_s=ref_s, launches=ref_launches, h2d_bytes=h2d_bytes,
                            f32_rel=ref_rel)
    del pk, pp, fc, fc_exp, fc_ema, nets
    os.remove(ref_path)
    torch.cuda.empty_cache()

    # (d) the trained CP forecaster, decoded by the port's reader
    path = Path(__file__).resolve().parent / "results" / "skill_fast08" / "forecaster.msgpack"
    t0 = time.perf_counter()
    tree = flax_msgpack.read(str(path))
    decode_s = time.perf_counter() - t0
    net = SFNO(SFNOConfig(img_shape=(64, 128), in_chans=4, out_chans=2, embed_dim=64,
                          num_layers=4, with_time_emb=True, min_time=0, max_time=5,
                          hard_thresholding_fraction=0.8, factorization="cp", rank=0.25))
    sd = flax_to_state_dict(tree)
    net.load_state_dict(sd, strict=True)
    leaves = len(sd)
    nbytes = sum(v.numel() * v.element_size() for v in sd.values())
    log(f"results/skill_fast08 forecaster: {path.stat().st_size} bytes decoded without flax in "
        f"{decode_s:.3f} s; {leaves} parameter leaves, {nbytes} bytes, loaded strictly")
    cli["skill_fast08"] = dict(leaves=leaves, bytes=nbytes, decode_s=decode_s)
    tmp.cleanup()
    report["cli"] = cli


def phase13(smi_line, wrappers, report, runs, drive, pair, other, device="cuda") -> None:
    """Phase 13: the model options at OPT_EMBED x OPT_LAYERS on OPT_SHAPE:
    (a) the Tucker window, (b) the folded window, (c) remat training, (d)
    one forward of each other option and one data+noise forecaster step.
    ``drive`` and ``pair`` are phase 6's window helpers, ``other`` the
    model-driven channels."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from spherical_dyffusion_tpu_torch import main_path
    from spherical_dyffusion_tpu_torch.models.sfno import SFNO

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    L = OPT_LAYERS
    H, W = OPT_SHAPE
    opts = {}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def zero_counts():
        for fn in wrappers.values():
            fn.launches = 0

    def free():
        """Collect the dead networks of earlier phases (reference cycles
        keep some of them until the cyclic collector runs) and return the
        cache, so that a peak-memory figure counts only what is live."""
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    def model_gap(kern, plain):
        """max |kernels - plain| over the largest model-driven prediction."""
        return (kern - plain).abs().max().item() / plain[..., other].abs().max().item()

    fused_tail_s = runs["fused_tail"]["seconds"]

    # (a) the Tucker window: the rank pipeline in blocks 1-6, K3 in every block
    tucker_kw = dict(main_path.TUCKER_WINDOW)
    run = drive("Tucker window", tucker_kw, {"K1": 0, "K2": 0, "K3": L, "K4": 0})
    runs["tucker"] = run
    log(f"Tucker window (rank 0.25, 2R = {OPT_EMBED // 2}): {N_STEPS} steps in "
        f"{run['seconds']:.3f} s against phase 7's fused-tail window {fused_tail_s:.3f} s "
        f"on {smi_line}")
    check(run["launches"]["K3"] == 24 * L and run["forwards"] == 24,
          f"Tucker window: K3 launched {run['launches']['K3']} times in {run['forwards']} "
          f"SFNO forwards, expected {24 * L}")
    pk, pp = pair("float32", tucker_kw, dict(tucker_kw, fused_tail=False))
    tucker_gap = model_gap(pk, pp)
    log(f"Tucker window float32, dropout off: max |K3 - plain| {tucker_gap:.3e} of the "
        f"largest model-driven prediction (tolerance 1e-4)")
    check(tucker_gap <= 1e-4, "Tucker window float32: K3 disagrees with the plain path")
    del pk, pp
    free()
    opts["tucker"] = dict(seconds=run["seconds"], steps_per_s=N_STEPS / run["seconds"],
                          phase7_seconds=fused_tail_s, launches=run["launches"],
                          f32_rel=tucker_gap)

    # (b) the folded window: phase 7's path with sht_fold_symmetry
    fold_kw = dict(use_pallas=True, fused_tail=True, peel=True, scan_layers=True,
                   sht_fold_symmetry=True)
    run = drive("folded window", fold_kw, {"K1": L, "K2": 0, "K3": L, "K4": 0})
    runs["fold"] = run
    log(f"folded window: {N_STEPS} steps in {run['seconds']:.3f} s against phase 7's unfolded "
        f"fused-tail window {fused_tail_s:.3f} s ({run['seconds'] / fused_tail_s - 1:+.1%}) "
        f"on {smi_line}")
    check(run["launches"]["K1"] == run["launches"]["K3"] == 24 * L,
          f"folded window: launches {run['launches']}, expected K1 and K3 {24 * L}")
    pk, pp = pair("float32", fold_kw, dict(fold_kw, sht_fold_symmetry=False))
    fold_gap = model_gap(pk, pp)
    log(f"folded window float32, dropout off: max |folded - unfolded| {fold_gap:.3e} of the "
        f"largest model-driven prediction (tolerance 1e-4)")
    check(fold_gap <= 1e-4, "folded window float32: folded and unfolded disagree")
    del pk, pp
    free()
    opts["fold"] = dict(seconds=run["seconds"], steps_per_s=N_STEPS / run["seconds"],
                        phase7_seconds=fused_tail_s, launches=run["launches"],
                        f32_rel=fold_gap)

    # (c) remat training: scan_layers and checkpointing=3, float32, K1 on,
    # dropout and DropPath live
    size = dict(embed=OPT_EMBED, layers=L, img_shape=OPT_SHAPE, device=device)
    free()
    # the earlier phases drop what they built, so the peak below is the
    # trainers' own, as phase 11's
    live_gb = torch.cuda.memory_allocated() / 1e9 if cuda else 0.0
    if live_gb > REMAT_LIVE_GB:
        _, largest = live_cuda_tensors()
        log(f"remat training: the largest CUDA tensors still live: {largest}")
    log(f"remat training: {live_gb:.3f} GB allocated on the card before the trainers are built")
    check(live_gb <= REMAT_LIVE_GB,
          f"remat training: {live_gb:.3f} GB left live by the earlier phases, more than "
          f"{REMAT_LIVE_GB} GB")
    zero_counts()
    t0 = time.perf_counter()
    trainers = main_path.build_training(scan_layers=True, checkpointing=3,
                                        n_samples=REMAT_STEPS, **size)
    rec = main_path.train_steps(n_steps=REMAT_STEPS, trainers=trainers)
    off = {k: wrappers[k].launches for k in ("K2", "K3", "K4")}
    check(not any(off.values()), f"remat training launched kernels without a backward: {off}")
    log(f"remat training: {REMAT_STEPS} steps of each experiment, built and run in "
        f"{time.perf_counter() - t0:.2f} s")
    # per step: (K1 launches, those in the backward, dx): the forward, the
    # recompute and dx per trained SFNO; the frozen interpolator's forward
    # in a forecaster step
    per_step = {"interpolator": (3 * L, 2 * L, L), "forecaster": (4 * L, 2 * L, L)}
    remat = {}
    k1_total = 0
    for name, r in rec.items():
        med = float(np.median(r["step_ms"][2:]))
        peak = r["peak_bytes"] / 1e9 if r["peak_bytes"] is not None else float("nan")
        ref = report["training"][name]
        log(f"remat training {name}: losses {[round(v, 5) for v in r['losses']]}; step ms "
            f"{[round(v, 1) for v in r['step_ms']]}, median after 2 warm-up steps {med:.2f} ms "
            f"(phase 11 without remat {ref['step_ms']:.2f} ms, {med / ref['step_ms'] - 1:+.1%}); "
            f"peak device memory {peak:.3f} GB (phase 11 {ref['peak_gb']:.3f} GB); K1 launches "
            f"per step {r['k1_launches']} (backward {r['k1_backward']}, dx {r['k1_dx']}), "
            f"images per step {r['k1_images']} on {smi_line}")
        check(all(np.isfinite(v) for v in r["losses"]), f"remat training {name}: a non-finite loss")
        got = list(zip(r["k1_launches"], r["k1_backward"], r["k1_dx"]))
        check(got == [per_step[name]] * REMAT_STEPS,
              f"remat training {name}: K1 (launches, backward, dx) per step {got}, expected "
              f"{per_step[name]}")
        images = [2 * L] * REMAT_STEPS
        if name == "forecaster":
            images[0] += L
        check(r["k1_images"] == images,
              f"remat training {name}: K1 images per step {r['k1_images']}, expected {images}")
        k1_total += sum(r["k1_launches"])
        remat[name] = dict(step_ms=med, steps_per_s=1e3 / med, peak_gb=peak,
                           phase11_step_ms=ref["step_ms"], phase11_peak_gb=ref["peak_gb"],
                           live_gb_before=live_gb,
                           losses=r["losses"], k1_launches=sum(r["k1_launches"]),
                           k1_dx=sum(r["k1_dx"]))
    runs["remat"] = dict(launches={"K1": k1_total, "K2": 0, "K3": 0, "K4": 0})
    del trainers, rec
    free()

    # remat against no remat: the same weights, batches and generator seed,
    # dropout live; the gradients taken from inside each train step
    kw = dict(scan_layers=True, n_samples=REMAT_CMP_STEPS, **size)
    with_remat = main_path.build_training(checkpointing=3, **kw)
    without = main_path.build_training(checkpointing=0, **kw)
    real_grad = torch.autograd.grad
    grabbed = []

    def grab(*a, **k):
        out = real_grad(*a, **k)
        grabbed.append([g.detach().clone() for g in out])
        return out

    for name in ("interpolator", "forecaster"):
        a, b = with_remat[name], without[name]
        b.exp.model.load_state_dict(a.exp.model.state_dict())
        if name == "forecaster":
            b.exp.interpolator.model.load_state_dict(a.exp.interpolator.model.state_dict())
        states = (a.init_state(), b.init_state())
        gens = (torch.Generator().manual_seed(13), torch.Generator().manual_seed(13))
        l_rel = g_rel = 0.0
        same_gen = True
        batches = [x for _, x in zip(range(REMAT_CMP_STEPS), a.dm.train_batches(seed=0))]
        torch.autograd.grad = grab
        try:
            for batch in batches:
                losses = []
                for tr, state, gen in zip((a, b), states, gens):
                    dyn, cond, rt = tr.upload(batch)
                    losses.append(float(tr.train_step(state, dyn, cond, gen, rt)["loss"]))
                gb = grabbed.pop()
                ga = grabbed.pop()
                l_rel = max(l_rel, abs(losses[0] - losses[1]) / abs(losses[1]))
                for x, y in zip(ga, gb):
                    d, sc = float((x - y).abs().max()), float(y.abs().max())
                    g_rel = max(g_rel, d / sc if sc > 0 else (0.0 if d == 0 else float("inf")))
                same_gen &= torch.equal(gens[0].get_state(), gens[1].get_state())
                del ga, gb
        finally:
            torch.autograd.grad = real_grad
        log(f"remat against no remat, {name}, {REMAT_CMP_STEPS} steps, dropout live: losses max "
            f"rel gap {l_rel:.3e}, gradients max gap {g_rel:.3e} of each tensor's largest entry "
            f"(tolerance 1e-6), generator states {'equal' if same_gen else 'DIFFERENT'} after "
            f"every step")
        check(l_rel <= 1e-6 and g_rel <= 1e-6 and same_gen,
              f"remat {name}: losses, gradients or generator state differ from no remat")
        remat[name]["vs_no_remat"] = dict(steps=REMAT_CMP_STEPS, loss_rel=l_rel, grad_rel=g_rel,
                                          generator_equal=same_gen)
    del with_remat, without, states
    free()
    opts["remat"] = remat

    # (d) one float32 forward at batch 1 of each other option
    base = main_path.sfno_configs(OPT_EMBED, L, "float32", OPT_SHAPE, use_pallas=False,
                                  fused_mlp=False)[1]
    g = torch.Generator(device=dev).manual_seed(13)
    x = torch.randn((1, H, W, base.out_chans), device=dev, generator=g)
    forcing = torch.randn((1, H, W, base.in_chans - base.out_chans), device=dev, generator=g)
    t = torch.ones(1, device=dev)
    cases = {
        "TT rank 0.25": dict(factorization="tt", rank=0.25),
        "Tucker rank 0.25 in spectral space": dict(factorization="tucker", rank=0.25,
                                                   rank_pipeline=False),
        "non-linear filter, shared (diagonal)": dict(filter_type="non-linear",
                                                     operator_type="diagonal"),
        "non-linear filter, per degree (l-dependant)": dict(filter_type="non-linear",
                                                            operator_type="l-dependant"),
        "layer norm": dict(normalization_layer="layer_norm"),
        "FFT transform, K1": dict(spectral_transform="fft", use_pallas=True),
        "SHT with lon_method fft, K1": dict(lon_method="fft", use_pallas=True),
        "merged dhconv": dict(merged_dhconv=True),
        "separable dhconv": dict(separable=True),
        f"diagonal filter at embed {OPT_DIAG_EMBED}": dict(operator_type="diagonal",
                                                           embed_dim=OPT_DIAG_EMBED),
    }
    log(f"option forwards: the diagonal filter runs at embed {OPT_DIAG_EMBED}: at "
        f"{OPT_EMBED} its weight (ci, co, l, m, 2) float32 is "
        f"{OPT_EMBED ** 2 * H * (W // 2 + 1) * 2 * 4 / 1e9:.1f} GB a block, "
        f"{L * OPT_EMBED ** 2 * H * (W // 2 + 1) * 2 * 4 / 1e9:.0f} GB over {L} blocks, "
        f"beyond the card's memory")
    forwards = {}
    for name, kw in cases.items():
        free()
        net = SFNO(dataclasses.replace(base, **kw)).to(dev)
        net.init_weights(torch.Generator(device=dev).manual_seed(0))
        with torch.no_grad():
            net(x, time=t, static_condition=forcing)  # warm-up: K1's image, cuBLAS
            sync()
            zero_counts()
            t0 = time.perf_counter()
            y = net(x, time=t, static_condition=forcing)
            sync()
            ms = (time.perf_counter() - t0) * 1e3
        k1 = wrappers["K1"].launches
        finite = bool(torch.isfinite(y).all())
        log(f"option forward {name}: {ms:.2f} ms at batch 1, float32, output "
            f"{tuple(y.shape)} finite {finite}, K1 launches {k1} on {smi_line}")
        check(finite and tuple(y.shape) == (1, H, W, base.out_chans),
              f"option forward {name}: non-finite or misshapen output")
        check(k1 == (L if kw.get("use_pallas") else 0),
              f"option forward {name}: K1 launched {k1} times")
        forwards[name] = dict(ms=ms, k1_launches=k1)
        del net, y
    opts["forwards"] = forwards
    free()

    # a forecaster training step with data+noise-v2, the extra condition
    # channels built in; the noise is drawn on the card
    trs = main_path.build_training(forward_conditioning="data+noise-v2", n_samples=1, **size)
    tr = trs["forecaster"]
    state = tr.init_state()
    dyn, cond, rt = tr.upload(next(iter(tr.dm.train_batches(seed=0))))
    gen = torch.Generator().manual_seed(3)
    tr.train_step(state, dyn, cond, gen, rt)  # warm-up: K1's images, cuBLAS
    sync()
    act_bytes = H * W * OPT_EMBED * 4
    control = torch.ones(1 << 18)
    nbytes = control.numel() * 4
    # every aten op of the step passes through the dispatch mode (the
    # backward's too), so no host-to-device copy goes unseen, as a profiler
    # trace's could; the 1 MiB control copy before the step shows it counting
    with host_to_device() as seen:
        control.to(dev)
        t0 = time.perf_counter()
        loss = float(tr.train_step(state, dyn, cond, gen, rt)["loss"])
        sync()
        step_ms = (time.perf_counter() - t0) * 1e3
    h2d = seen.copies
    n_control = sum(b == nbytes for _, b in h2d)
    h2d_bytes = sum(b for _, b in h2d) - n_control * nbytes
    log(f"data+noise-v2 forecaster step (in_chans {tr.exp.model.cfg.in_chans}): loss {loss:.5f}, "
        f"{step_ms:.2f} ms under the dispatch mode; host-to-device {len(h2d)} copies, "
        f"{sorted({(op, b) for op, b in h2d})}, {h2d_bytes} bytes besides the 1 MiB control "
        f"(seen {n_control} time(s), expected 1; one activation is {act_bytes} bytes)")
    check(np.isfinite(loss), "data+noise-v2 forecaster step: a non-finite loss")
    check(not cuda or n_control == 1, f"the dispatch mode saw the control copy {n_control} times")
    check(h2d_bytes < act_bytes // 100,
          f"data+noise-v2: {h2d_bytes} bytes copied from the host in one training step")
    opts["data_noise"] = dict(loss=loss, step_ms=step_ms, h2d_bytes=h2d_bytes,
                              h2d_copies=len(h2d) - n_control,
                              in_chans=tr.exp.model.cfg.in_chans)
    del trs, tr, state, dyn, cond
    free()
    report["options"] = opts


def phase14(smi_line, wrappers, report, runs, device="cuda") -> None:
    """Phase 14: training's other modes at MODES_EMBED x MODES_LAYERS on
    MODES_SHAPE, batch 1, K1 on: (c) bf16-compute steps, (d) bf16 Adam
    moments, (a) the fused epoch, (b) streaming, (e) the rollout validation
    inside ``fit``, (f) gradient histograms, (g) the code snapshot (run in
    this order: (c) and (d) measure peak memory from a card that holds only
    their freshly built trainers, as phase 11 does)."""
    import contextlib
    import gc
    import io
    import tarfile
    import tempfile

    import numpy as np
    import torch

    from spherical_dyffusion_tpu_torch import main_path
    from spherical_dyffusion_tpu_torch.data.datamodule import DebugDataModule
    from spherical_dyffusion_tpu_torch.ops.pallas_contractions import dhconv
    from spherical_dyffusion_tpu_torch.training import trainer as trainer_mod
    from spherical_dyffusion_tpu_torch.training.optim import AdamWLowMu
    from spherical_dyffusion_tpu_torch.training.trainer import Trainer, TrainerConfig

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    L = MODES_LAYERS
    size = dict(embed=MODES_EMBED, layers=L, img_shape=MODES_SHAPE, device=device)
    modes = {}

    def zero_counts():
        for fn in wrappers.values():
            fn.launches = 0
        dhconv.dx_launches = 0

    def free():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    @contextlib.contextmanager
    def no_sync(what):
        """Fail on any synchronizing CUDA call inside (the sync debug mode
        "error"), but for the epochs' ends: ``Trainer._read_epoch`` reads the
        losses with an ordinary copy, outside the check, and is counted in
        the list yielded (the caller holds it to the epochs run)."""
        reads = [0]
        real_read = Trainer._read_epoch

        def read_outside(*a):
            reads[0] += 1
            if cuda:
                torch.cuda.set_sync_debug_mode(0)
            try:
                return real_read(*a)
            finally:
                if cuda:
                    torch.cuda.set_sync_debug_mode("error")

        Trainer._read_epoch = staticmethod(read_outside)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            yield reads
        except RuntimeError as e:
            raise SystemExit(f"chip_smoke: FAILED: {what} made a synchronizing CUDA call: {e}")
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(0)
            Trainer._read_epoch = staticmethod(real_read)

    def reinit(trainers):
        """The weights ``build_training`` draws (seed 0, interpolator first)."""
        gen = torch.Generator(device=dev).manual_seed(0)
        trainers["interpolator"].exp.model.init_weights(gen)
        trainers["forecaster"].exp.model.init_weights(gen)

    def rel(a, b):
        return abs(a - b) / abs(b)

    free()
    live_gb = torch.cuda.memory_allocated() / 1e9 if cuda else 0.0
    if live_gb > REMAT_LIVE_GB:
        _, largest = live_cuda_tensors()
        log(f"training modes: the largest CUDA tensors still live: {largest}")
    log(f"training modes: {live_gb:.3f} GB allocated on the card before phase 14")
    check(live_gb <= REMAT_LIVE_GB,
          f"training modes: {live_gb:.3f} GB left live by the earlier phases, more than "
          f"{REMAT_LIVE_GB} GB")
    ref11 = report["training"]

    # (c) bf16-compute training: 3 steps of each experiment, K1 float32
    zero_counts()
    bf = main_path.train_steps(n_steps=MODES_STEPS, trainers=main_path.build_training(
        dtype="bfloat16", n_samples=FUSED_STEPS, **size))
    off = {k: wrappers[k].launches for k in ("K2", "K3", "K4")}
    check(not any(off.values()), f"bf16 training launched kernels without a backward: {off}")
    k1_bf16 = sum(sum(r["k1_launches"]) for r in bf.values())
    bf_rows = {name: dict(losses=r["losses"], grad_norms=r["grad_norms"],
                          step_ms=float(np.median(r["step_ms"][1:])),
                          step_ms_all=r["step_ms"],
                          peak_gb=(r["peak_bytes"] or 0) / 1e9, k1=r["k1_launches"],
                          dx=r["k1_dx"], dtype=r["trainer"].exp.model.cfg.compute_dtype)
               for name, r in bf.items()}
    del bf
    free()
    f32 = main_path.build_training(n_samples=FUSED_STEPS, **size)
    # (d), timed: bf16 Adam moments on the fresh networks, whose peak counts
    # what phase 11's does (no K1 image is made before the first step)
    itr = f32["interpolator"]
    mu_cfg = TrainerConfig(epochs=1, steps_per_epoch=FUSED_STEPS, scheduler="constant",
                           adam_mu_dtype="bfloat16")
    mu_live = torch.cuda.memory_allocated() / 1e9 if cuda else 0.0
    timed_mu = main_path.train_steps(n_steps=MODES_STEPS, trainers={
        "interpolator": Trainer(itr.exp, itr.dm, mu_cfg)})["interpolator"]
    mu_ms = float(np.median(timed_mu["step_ms"][1:]))
    mu_opt_ms = float(np.median([s["optimizer"] for s in timed_mu["split_ms"][1:]]))
    mu_ms_all = timed_mu["step_ms"]
    mu_peak = timed_mu["peak_bytes"] / 1e9 if timed_mu["peak_bytes"] else float("nan")
    del timed_mu
    free()
    reinit(f32)
    ref = main_path.train_steps(n_steps=MODES_STEPS, trainers=f32)
    per_step = {"interpolator": (2 * L, L), "forecaster": (3 * L, L)}
    for name, r in bf_rows.items():
        gaps = [rel(a, b) for a, b in zip(r["losses"], ref[name]["losses"])]
        gn_gap = max(rel(a, b) for a, b in zip(r["grad_norms"], ref[name]["grad_norms"]))
        log(f"bf16 training {name}: losses {[round(v, 5) for v in r['losses']]} against float32 "
            f"{[round(v, 5) for v in ref[name]['losses']]} (max rel gap {max(gaps):.3e}, "
            f"tolerance {BF16_VS_F32_LOSS}); gradient norms max rel gap {gn_gap:.3e} (floor "
            f"{BF16_GRAD_NORM_FLOOR}); median step after the first {r['step_ms']:.2f} ms "
            f"(steps {[round(v, 2) for v in r['step_ms_all']]} ms; phase 11 float32 {ref11[name]['step_ms']:.2f} ms); peak {r['peak_gb']:.3f} GB "
            f"(phase 11 {ref11[name]['peak_gb']:.3f} GB); K1 launches per step {r['k1']} "
            f"(dx {r['dx']}) on {smi_line}")
        check(r["dtype"] == "bfloat16" and all(np.isfinite(r["losses"])),
              f"bf16 training {name}: not bf16, or a non-finite loss")
        check(max(gaps) <= BF16_VS_F32_LOSS,
              f"bf16 training {name}: loss {max(gaps):.3e} from the float32 run's")
        check(gn_gap > BF16_GRAD_NORM_FLOOR,
              f"bf16 training {name}: gradient norms {gn_gap:.3e} from the float32 run's, "
              f"not above {BF16_GRAD_NORM_FLOOR}: the step did not compute in bf16")
        want = per_step[name]
        check(list(zip(r["k1"], r["dx"])) == [want] * MODES_STEPS,
              f"bf16 training {name}: K1 (launches, dx) per step {list(zip(r['k1'], r['dx']))}, "
              f"expected {want}")
        r.update(f32_losses=ref[name]["losses"], loss_rel=max(gaps), grad_norm_rel=gn_gap,
                 phase11_step_ms=ref11[name]["step_ms"], phase11_peak_gb=ref11[name]["peak_gb"])
    modes["bf16_compute"] = bf_rows
    runs["bf16"] = dict(launches={"K1": k1_bf16, "K2": 0, "K3": 0, "K4": 0})
    del ref, r
    free()  # the float32 run's states (moments, EMA) sit in reference cycles

    # (d) bf16 Adam moments: the same 3 steps again with the gradients and
    # weight decays the optimizer saw kept on the host, against float64 optax
    reinit(f32)
    mu_tr = Trainer(itr.exp, itr.dm, mu_cfg)
    p0 = {n: p.detach().to("cpu", copy=True) for n, p in itr.exp.model.named_parameters()}
    seen = []
    real_step = AdamWLowMu.step

    def record_step(self, closure=None):
        seen.append([(p.grad.to("cpu"), g["weight_decay"], g["lr"])
                     for g in self.param_groups for p in g["params"]])
        return real_step(self, closure)

    AdamWLowMu.step = record_step
    try:
        mu = main_path.train_steps(n_steps=MODES_STEPS, trainers={"interpolator": mu_tr})
    finally:
        AdamWLowMu.step = real_step
    st = mu["interpolator"]["state"]
    order = [p for g in st.optimizer.param_groups for p in g["params"]]
    names = {id(p): n for n, p in itr.exp.model.named_parameters()}
    all_bf16 = all(st.optimizer.state[p]["exp_avg"].dtype == torch.bfloat16 for p in order)
    b1, b2, eps = 0.9, 0.999, 1e-8
    b1_mu = float(torch.tensor(b1, dtype=torch.bfloat16))
    worst = 0.0
    for i, p in enumerate(order):
        # optax's rule in float64: mu = (1 - b1) g + bf16(bf16(b1) mu_stored),
        # the update from that mu, then mu rounded to bf16 for storage
        x = p0[names[id(p)]].to(dev, torch.float64)
        m_st = torch.zeros_like(x)
        v = torch.zeros_like(x)
        for k, rec in enumerate(seen, start=1):
            g, wd, lr = rec[i]
            g = g.to(dev, torch.float64)
            m = (1 - b1) * g + (b1_mu * m_st.to(torch.bfloat16).float()).to(
                torch.bfloat16).double()
            v = (1 - b2) * g * g + b2 * v
            upd = (m / (1 - b1 ** k)) / (torch.sqrt(v / (1 - b2 ** k)) + eps) + wd * x
            x = x - lr * upd
            m_st = m.to(torch.bfloat16).double()
        # 1e-6 of the tensor plus AdamW's response to one bf16 step of mu at
        # each update (|mu_hat / sqrt(nu_hat)| is at most about 1)
        tol = 1e-6 * float(x.abs().max()) + len(seen) * seen[0][i][2] * 2.0 ** -7
        err = float((p.detach().double() - x).abs().max())
        worst = max(worst, err / tol)
    r = mu["interpolator"]
    mu_row = dict(losses=r["losses"], step_ms=mu_ms, step_ms_all=mu_ms_all, peak_gb=mu_peak,
                  phase11_peak_gb=ref11["interpolator"]["peak_gb"],
                  phase11_step_ms=ref11["interpolator"]["step_ms"], live_gb_before=mu_live,
                  optimizer_ms=mu_opt_ms,
                  phase11_optimizer_ms=ref11["interpolator"]["split_ms"]["optimizer"],
                  all_exp_avg_bf16=all_bf16,
                  param_err_over_tol=worst, updates=len(seen))
    log(f"bf16 Adam moments: {len(seen)} updates at lr 4e-4, every exp_avg bf16: {all_bf16}; the "
        f"parameters against float64 optax with mu rounded to bf16: max error {worst:.3f} of "
        f"its tolerance (1e-6 of the tensor plus one bf16 step of mu per update); peak "
        f"{mu_row['peak_gb']:.3f} GB ({mu_live:.3f} GB live before it: both networks, as in "
        f"phase 11) against "
        f"phase 11's {mu_row['phase11_peak_gb']:.3f} GB "
        f"({mu_row['peak_gb'] - mu_row['phase11_peak_gb']:+.3f} GB); median step after the "
        f"first {mu_row['step_ms']:.2f} ms (steps {[round(v, 2) for v in mu_ms_all]} ms; phase "
        f"11 {mu_row['phase11_step_ms']:.2f} ms; both "
        f"from the run without the gradients kept), its optimizer and EMA "
        f"{mu_opt_ms:.2f} ms (phase 11 {mu_row['phase11_optimizer_ms']:.2f} ms) on {smi_line}")
    check(all_bf16 and len(seen) == MODES_STEPS, "bf16 Adam moments: an exp_avg is not bf16")
    check(worst <= 1.0, f"bf16 Adam moments: parameters {worst:.3f} x their tolerance from optax")
    modes["bf16_mu"] = mu_row
    del mu, mu_tr, st, order, seen, p0, r
    free()

    # (a) the fused epoch: FUSED_STEPS interpolator steps over a dataset
    # uploaded once; timed, then again under the dispatch mode, then fit
    # over the same rows with the epoch's generator
    reinit(f32)
    zero_counts()
    fused = main_path.fused_epoch(n_steps=FUSED_STEPS, trainer=itr)
    k1_fused, dx_fused = wrappers["K1"].launches, dhconv.dx_launches
    steps = fused["steps"]
    med = float(np.median(fused["step_ms"][1:]))
    log(f"fused epoch: {steps} steps in {fused['wall_s']:.3f} s (the call, dataset read and "
        f"upload included), median step after the first {med:.2f} ms (phase 11's "
        f"interpolator step {ref11['interpolator']['step_ms']:.2f} ms); the dataset "
        f"{fused['upload_bytes'] / 1e9:.3f} GB read, stacked and pinned in "
        f"{fused['upload_host_s']:.3f} s, copied in {fused['upload_copy_s']:.4f} s "
        f"({fused['upload_bytes'] / 1e9 / fused['upload_copy_s']:.1f} GB/s); K1 launches "
        f"{k1_fused} (dx {dx_fused}) on {smi_line}")
    check(steps == FUSED_STEPS and all(np.isfinite(fused["losses"])),
          f"fused epoch: {steps} steps or a non-finite loss")
    check(k1_fused == 2 * L * steps and dx_fused == L * steps,
          f"fused epoch: K1 {k1_fused} launches ({dx_fused} dx), expected {2 * L} ({L}) a step")
    reinit(f32)
    control = torch.ones(1 << 18)
    with host_to_device() as seen_h2d:
        control.to(dev)
        counted = main_path.fused_epoch(n_steps=FUSED_STEPS, trainer=itr)
    h2d = seen_h2d.copies
    nbytes = control.numel() * 4
    n_control = sum(b == nbytes for _, b in h2d)
    total = sum(b for _, b in h2d) - n_control * nbytes
    idx_bytes = FUSED_STEPS * 8
    per_step_bytes = total - counted["upload_bytes"] - idx_bytes
    log(f"fused epoch under the dispatch mode: {len(h2d) - n_control} host-to-device copies, "
        f"{total} bytes: the dataset {counted['upload_bytes']}, the permutation index "
        f"{idx_bytes}, the steps {per_step_bytes} (the 1 MiB control seen {n_control} time(s)); "
        f"copies (op, bytes): {sorted({(op, b) for op, b in h2d if b != nbytes})}; "
        f"losses {'equal' if counted['losses'] == fused['losses'] else 'DIFFERENT'} bit for bit "
        f"to the timed epoch's")
    check(not cuda or n_control == 1, f"the dispatch mode saw the control copy {n_control} times")
    check(per_step_bytes == 0, f"fused epoch: the steps copied {per_step_bytes} bytes from "
                               f"the host")
    check(counted["losses"] == fused["losses"], "fused epoch: a rerun from the same weights "
                                                "gave other losses")
    del counted
    reinit(f32)
    fit_tr = Trainer(itr.exp, itr.dm, TrainerConfig(epochs=1, steps_per_epoch=FUSED_STEPS))
    fit_tr.generator = fit_tr.epoch_generator(0)
    by_fit = fit_tr.fit(val_every=2, verbose=False)["step_losses"]
    fit_gap = max(rel(a, b) for a, b in zip(fused["losses"], by_fit))
    log(f"fused epoch against fit over the same rows and generator: losses max rel gap "
        f"{fit_gap:.3e} (tolerance 1e-5)")
    check(len(by_fit) == steps and fit_gap <= 1e-5, "fused epoch: losses differ from fit's")
    modes["fused_epoch"] = dict(steps=steps, wall_s=fused["wall_s"], step_ms=med,
                                step_ms_all=fused["step_ms"], losses=fused["losses"],
                                upload_bytes=fused["upload_bytes"],
                                upload_host_s=fused["upload_host_s"],
                                upload_copy_s=fused["upload_copy_s"],
                                h2d_step_bytes=per_step_bytes, h2d_index_bytes=idx_bytes,
                                fit_loss_rel=fit_gap, k1_launches=k1_fused, k1_dx=dx_fused,
                                phase11_step_ms=ref11["interpolator"]["step_ms"])
    runs["fused_epoch"] = dict(launches={"K1": k1_fused, "K2": 0, "K3": 0, "K4": 0})
    del fused, fit_tr
    free()

    # (b) streaming: FUSED_STEPS samples in segments of SEGMENT_SAMPLES, no
    # synchronizing call; against the same rows run by hand with each
    # segment's generator
    reinit(f32)
    zero_counts()
    st_tr = Trainer(itr.exp, itr.dm, TrainerConfig(epochs=1, steps_per_epoch=FUSED_STEPS))
    t0 = time.perf_counter()
    with no_sync("streaming") as reads:
        hist = st_tr.fit_in_memory(epochs=1, val_every=2, verbose=False,
                                   segment_samples=SEGMENT_SAMPLES)
    check(reads == [1], f"streaming: {reads[0]} epoch-end reads in one epoch")
    stream_s = time.perf_counter() - t0
    k1_stream = wrappers["K1"].launches
    streamed = hist["step_losses"]
    waits = hist["segment_wait_s"][0]
    reinit(f32)
    ref_tr = Trainer(itr.exp, itr.dm, TrainerConfig(epochs=1, steps_per_epoch=FUSED_STEPS))
    state = ref_tr.init_state()
    ds = itr.dm.dataset("train")
    perm = np.random.default_rng(0).permutation(len(ds))[:FUSED_STEPS]
    keyed = []
    for si in range(FUSED_STEPS // SEGMENT_SAMPLES):
        gen = ref_tr.epoch_generator(0, si)
        for row in perm[si * SEGMENT_SAMPLES:(si + 1) * SEGMENT_SAMPLES]:
            b = ref_tr._read_rows(ds, [row], ["dynamics", "dynamical_condition"])
            keyed.append(ref_tr.train_step(state, b["dynamics"].to(dev),
                                           b["dynamical_condition"].to(dev), gen)["loss"])
    keyed = [float(v) for v in keyed]
    stream_gap = max(rel(a, b) for a, b in zip(streamed, keyed))
    log(f"streaming: {len(streamed)} steps in {len(waits)} segments of {SEGMENT_SAMPLES} in "
        f"{stream_s:.3f} s, no synchronizing CUDA call (sync debug mode 'error'); the host's "
        f"wait for each segment {[round(w, 4) for w in waits]} s; losses against the same rows "
        f"keyed the same way max rel gap {stream_gap:.3e} (tolerance 1e-5); K1 launches "
        f"{k1_stream} on {smi_line}")
    check(len(streamed) == FUSED_STEPS and len(waits) == FUSED_STEPS // SEGMENT_SAMPLES,
          f"streaming: {len(streamed)} steps in {len(waits)} segments")
    check(stream_gap <= 1e-5, "streaming: losses differ from the same rows keyed the same way")
    check(k1_stream == 2 * L * FUSED_STEPS, f"streaming: K1 launched {k1_stream} times")
    modes["streaming"] = dict(steps=len(streamed), seconds=stream_s, segment_wait_s=waits,
                              loss_rel=stream_gap, k1_launches=k1_stream)
    runs["streaming"] = dict(launches={"K1": k1_stream, "K2": 0, "K3": 0, "K4": 0})
    del st_tr, ref_tr, state, hist
    free()

    # (e) the rollout validation of the forecaster inside fit, on its EMA
    # weights: ROLLOUT_VAL_STEPS steps, no synchronizing call in the rollout
    reinit(f32)
    ftr = f32["forecaster"]
    rv_tr = Trainer(ftr.exp, ftr.dm, TrainerConfig(epochs=1, steps_per_epoch=FUSED_STEPS,
                                                   rollout_val_every=1,
                                                   rollout_val_steps=ROLLOUT_VAL_STEPS))
    nets = (ftr.exp.model, ftr.exp.interpolator.model)
    rollout = {}
    real_run = trainer_mod.run_inference

    def counted_run(*a, **k):
        forwards = [0]
        hooks = [n.register_forward_pre_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1))
                 for n in nets]
        zero_counts()
        t0 = time.perf_counter()
        try:
            with no_sync("the rollout validation"):
                out = real_run(*a, **k)
        finally:
            for h in hooks:
                h.remove()
        rollout.update(seconds=time.perf_counter() - t0, forwards=forwards[0],
                       k1=wrappers["K1"].launches)
        return out

    trainer_mod.run_inference = counted_run
    try:
        hist = rv_tr.fit(val_every=2, verbose=False)
    finally:
        trainer_mod.run_inference = real_run
    rv = hist["rollout_val"][0]
    # the key set: the port's at debug size on the CPU (held to the JAX
    # package's there by tests/test_torch_port_train_modes.py), its names
    # those of this run
    debug = main_path.build_training(embed=16, layers=2, img_shape=(16, 32), horizon=3,
                                     n_state=5, n_samples=12, device="cpu")["forecaster"]
    debug = Trainer(debug.exp, debug.dm, TrainerConfig(rollout_val_steps=6))
    debug_names = list(debug.exp.out_packer.names)
    debug_keys = debug.rollout_validate(debug.init_state())
    groups = {k.rsplit("/", 1)[0] for k in debug_keys if k.rsplit("/", 1)[1] in debug_names}
    want = ({k for k in debug_keys if k.rsplit("/", 1)[1] not in debug_names}
            | {f"{g}/{n}" for g in groups for n in ftr.exp.out_packer.names})
    finite = all(np.isfinite(v) for v in rv.values())
    rate = ROLLOUT_VAL_STEPS / rollout["seconds"]
    log(f"rollout validation (EMA weights, {ROLLOUT_VAL_STEPS} steps): {len(rv)} keys, equal to "
        f"the expected set: {set(rv) == want}; finite {finite}; val/avg/rmse "
        f"{rv.get('val/avg/rmse', float('nan')):.5f}; {rollout['seconds']:.3f} s = {rate:.3f} "
        f"steps/s with no synchronizing CUDA call; {rollout['forwards']} SFNO forwards, K1 "
        f"launches {rollout['k1']} on {smi_line}")
    check(set(rv) == want and finite, f"rollout validation: keys {sorted(set(rv) ^ want)[:6]} "
                                      f"differ, or a value is not finite")
    check(rollout["k1"] == L * rollout["forwards"] and rollout["forwards"] > 0,
          f"rollout validation: K1 launched {rollout['k1']} times in {rollout['forwards']} "
          f"forwards")
    modes["rollout_val"] = dict(steps=ROLLOUT_VAL_STEPS, seconds=rollout["seconds"],
                                steps_per_s=rate, keys=len(rv), forwards=rollout["forwards"],
                                k1_launches=rollout["k1"], rmse=rv.get("val/avg/rmse"))
    runs["rollout_val"] = dict(launches={"K1": rollout["k1"], "K2": 0, "K3": 0, "K4": 0})
    del rv_tr, hist, debug
    free()

    # (f) gradient histograms: fit, log_every 2, HIST_STEPS steps, against
    # the same steps without them; no synchronizing call in the fit
    class Rows:
        def __init__(self):
            self.rows = []

        def log(self, row, step=None):
            self.rows.append((step, row))

    hist_dm = DebugDataModule(channels=35, height=MODES_SHAPE[0], width=MODES_SHAPE[1],
                              horizon=6, n_forcing=2, batch_size=1, n_timesteps=6 + HIST_STEPS,
                              seed=0)
    step_ms, logs = {}, {}
    for watch in (False, True):
        reinit(f32)
        tr = Trainer(itr.exp, hist_dm, TrainerConfig(epochs=1, log_every=2, warmup_steps=1,
                                                     watch_histograms=watch))
        marks = []
        step = tr.train_step

        def timed_step(*a, step=step, marks=marks, **k):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if cuda else []
            for e in ev[:1]:
                e.record()
            t = time.perf_counter()
            out = step(*a, **k)
            for e in ev[1:]:
                e.record()
            marks.append((ev, time.perf_counter() - t))
            return out

        tr.train_step = timed_step
        rows = Rows()
        with no_sync("a fit with gradient histograms" if watch else "a fit") as reads:
            tr.fit(val_every=2, verbose=False, logger=rows)
        check(reads == [1], f"histograms: {reads[0]} epoch-end reads in one epoch")
        step_ms[watch] = [ev[0].elapsed_time(ev[1]) if ev else host * 1e3 for ev, host in marks]
        logs[watch] = rows.rows
        del tr, step, timed_step
    logged = [s for s, r in logs[True] if any(k.startswith("train/grad_hist/") for k in r)]
    groups = {}
    for n, p in itr.exp.model.named_parameters():
        groups.setdefault(trainer_mod.subtree(itr.exp.model, n), 0)
        groups[trainer_mod.subtree(itr.exp.model, n)] += p.numel()
    sums_ok = True
    for s, r in logs[True]:
        for k, v in r.items():
            if k.startswith("train/grad_hist/"):
                sums_ok &= sum(v["values"]) == groups[k.split("/", 2)[2]] and len(v["bins"]) == 65
    with_h = [step_ms[True][i] for i in range(0, HIST_STEPS, 2)]
    without_h = [step_ms[False][i] for i in range(0, HIST_STEPS, 2)]
    # the logged steps after the first (the first also makes the K1 images)
    over = float(np.mean(np.subtract(with_h[1:], without_h[1:])))
    max_bin = max(max(v["values"]) for _, r in logs[True] for k, v in r.items()
                  if k.startswith("train/grad_hist/"))
    log(f"gradient histograms: logged at steps {logged}, {len(groups)} subtrees, counts summing "
        f"to each subtree's parameter count: {sums_ok}; the logged steps took "
        f"{[round(v, 2) for v in with_h]} ms with histograms and {[round(v, 2) for v in without_h]} "
        f"ms without (the first of each with the epoch's first K1 images): overhead "
        f"{over:.2f} ms a logged step after the first, by CUDA events; no synchronizing CUDA "
        f"call in either fit; the largest bin holds {max_bin} values (2^24 = {2 ** 24}) on "
        f"{smi_line}")
    check(logged == list(range(0, HIST_STEPS, 2)) and sums_ok,
          f"gradient histograms: logged at {logged}, or counts not summing to the parameters")
    modes["histograms"] = dict(logged_steps=logged, subtrees=len(groups), step_ms=step_ms[True],
                               step_ms_without=step_ms[False], overhead_ms=over,
                               max_bin=max_bin)

    # (g) the code snapshot: two fits into one checkpoint directory
    one = DebugDataModule(channels=35, height=MODES_SHAPE[0], width=MODES_SHAPE[1], horizon=6,
                          n_forcing=2, batch_size=1, n_timesteps=7, seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        tars = []
        for _ in range(2):
            Trainer(itr.exp, one, TrainerConfig(epochs=1, warmup_steps=1, ckpt_dir=tmp)).fit(
                val_every=2, verbose=False)
            with open(os.path.join(tmp, "code.tar.gz"), "rb") as f:
                tars.append(f.read())
        with tarfile.open(fileobj=io.BytesIO(tars[0])) as tar:
            members = set(tar.getnames())
    csrc = os.path.join(os.path.dirname(os.path.abspath(main_path.__file__)), "csrc")
    kernels = sorted(f"spherical_dyffusion_tpu_torch/csrc/{fn}" for fn in os.listdir(csrc)
                     if fn.endswith(".cu"))
    log(f"code snapshot: two fits into one directory left {len(tars[0])} and {len(tars[1])} "
        f"bytes, identical: {tars[0] == tars[1]}; {len(members)} files, holding "
        f"{[k for k in kernels if k in members]}")
    check(tars[0] == tars[1] and all(k in members for k in kernels),
          "code snapshot: not byte-stable, or a kernel source is missing")
    modes["code_snapshot"] = dict(bytes=len(tars[0]), files=len(members), kernels=kernels)
    del f32, itr, ftr, nets
    free()
    report["modes"] = modes


def phase15(smi_line, wrappers, report, runs, device="cuda") -> None:
    """Phase 15: the ACE family at ACE_EMBED x ACE_LAYERS on ACE_SHAPE, batch
    1: (a) ``main_path.ace_rollout`` (bf16, K1 and K3, the aggregator and
    the diagnostics on), then the same rollout counted (host-to-device bytes
    per window, no synchronizing call before its end sync); (b) one window
    with the kernels against the plain path, float32 and bf16; (c) the dry
    air and the ocean on the card; (d) a native ACE checkpoint through
    ``run_inference``; (e) simultaneous training, in float32 and float16;
    (g) float16 on the ACE path; (h) the slab ocean through
    ``run_inference``; (f) a profiled window (the module docstring has
    each part's checks)."""
    import functools
    import gc
    import statistics
    import tempfile

    import numpy as np
    import torch

    from spherical_dyffusion_tpu_torch import interface, main_path
    from spherical_dyffusion_tpu_torch.data.coords import SigmaCoordinates
    from spherical_dyffusion_tpu_torch.data.datasets import SyntheticTimeSeries
    from spherical_dyffusion_tpu_torch.evaluation.aggregators import InferenceAggregator
    from spherical_dyffusion_tpu_torch.evaluation.metrics import weighted_mean
    from spherical_dyffusion_tpu_torch.inference import ace_stepper
    from spherical_dyffusion_tpu_torch.inference.ace_stepper import (
        SingleStepStepper,
        ace_scored_names,
        run_ace_inference,
    )
    from spherical_dyffusion_tpu_torch.inference.climate_data import ClimateData
    from spherical_dyffusion_tpu_torch.ops.pallas_contractions import dhconv
    from spherical_dyffusion_tpu_torch.run_inference import main_from_config

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    L, T = ACE_LAYERS, ACE_WINDOW
    size = dict(embed=ACE_EMBED, layers=L, img_shape=ACE_SHAPE, levels=ACE_LEVELS,
                n_other=ACE_OTHER)
    ace = {}

    def zero_counts():
        for fn in wrappers.values():
            fn.launches = 0
        dhconv.dx_launches = 0

    def counts():
        return {k: fn.launches for k, fn in wrappers.items()}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def free():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    def rel(got, want):
        return float((got.float() - want.float()).abs().max() / want.float().abs().max())

    # (a) the rollout: ace_bench through run_ace_inference, timed
    n_windows = ACE_STEPS // T
    out = main_path.ace_rollout(n_steps=ACE_STEPS, window=T, dtype="bfloat16", kernels=True,
                                before_timed=zero_counts, device=device, **size)
    launches = counts()
    summary, ws = out["summary"], out["window_seconds"]
    steady = summary["steady_steps_per_second"]
    sim_yr = steady * 86400.0 / STEPS_PER_SIM_YEAR
    check(launches["K1"] == launches["K3"] == n_windows * T * L
          and launches["K2"] == launches["K4"] == 0,
          f"ACE rollout launches {launches}: want K1 = K3 = {T * L} a window, K2 = K4 = 0")
    logs_ok = all(np.isfinite(v) for v in out["logs"].values())
    gen_ok = all(bool(torch.isfinite(v).all()) for v in out["gen"].values())
    check(logs_ok and gen_ok and np.isfinite(summary["loss_last_window"]),
          "ACE rollout: a log or a generated field is not finite")
    log(f"ACE rollout (bf16, K1 + K3, aggregator and diagnostics on), {ACE_STEPS} steps in "
        f"{n_windows} windows of {T}: window seconds on the device {[round(s, 4) for s in ws]}, "
        f"steady {steady:.3f} steps/s = {sim_yr:.1f} sim-yr/day (x 86400 / "
        f"{STEPS_PER_SIM_YEAR}), total {summary['total_steps_per_second']:.3f} steps/s, "
        f"time/run_on_batch {summary['time/run_on_batch']:.3f} s (launching), data_loading "
        f"{summary['time/data_loading']:.3f} s; K1 {launches['K1'] // n_windows} and K3 "
        f"{launches['K3'] // n_windows} launches a window; {len(out['logs'])} logs finite, "
        f"the last window's {len(out['gen'])} fields finite, on {smi_line}")
    runs["ace"] = dict(launches=launches, seconds=ws[-1])
    ace["rollout"] = dict(steps=ACE_STEPS, window=T, window_seconds=ws,
                          steady_steps_per_second=steady, sim_years_per_day=sim_yr,
                          total_steps_per_second=summary["total_steps_per_second"],
                          run_on_batch_s=summary["time/run_on_batch"],
                          data_loading_s=summary["time/data_loading"],
                          launches_per_window={k: v // n_windows for k, v in launches.items()},
                          loss_last_window=summary["loss_last_window"])

    # the same rollout again, counted: host-to-device bytes per window (the
    # later windows repeat the looped source's offsets: the upload cache
    # holds them) and no synchronizing CUDA call before the end sync, whose
    # read of the last loss is lifted out of the check
    stepper, src = out["stepper"], out["source"]
    names = list(stepper.cfg.all_names)
    agg = InferenceAggregator(ace_scored_names(stepper, src, derived=True),
                              src.horizontal.area_weights(), log_zonal_mean_images=False)
    marks = []
    real_read = ace_stepper.read_back

    def read_outside(tensors):
        if cuda:
            torch.cuda.set_sync_debug_mode(0)
        try:
            return real_read(tensors)
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode("error")

    ace_stepper.read_back = read_outside
    sync()
    try:
        with host_to_device() as seen:
            if cuda:
                torch.cuda.set_sync_debug_mode("error")
            run_ace_inference(stepper, src, ACE_STEPS, T,
                              n_repeats=-(-(ACE_STEPS + 1) // src.n_timesteps), aggregator=agg,
                              derived=True, verbose=False,
                              on_window=lambda s, o: marks.append(len(seen.copies)))
    except RuntimeError as e:
        raise SystemExit(f"chip_smoke: FAILED: the ACE rollout made a synchronizing CUDA call "
                         f"before its end sync: {e}")
    finally:
        if cuda:
            torch.cuda.set_sync_debug_mode(0)
        ace_stepper.read_back = real_read
    bounds = [0] + marks
    per_window = [sum(b for _, b in seen.copies[a:z]) for a, z in zip(bounds, bounds[1:])]
    frame_bytes = len(names) * (T + 1) * ACE_SHAPE[0] * ACE_SHAPE[1] * 4
    distinct = src.n_timesteps // T
    log(f"ACE rollout counted: host-to-device bytes per window {per_window} (one window of "
        f"{len(names)} names x {T + 1} frames x {ACE_SHAPE[0] * ACE_SHAPE[1]} points x 4 B = "
        f"{frame_bytes}; the first window also the aggregator's area weights), "
        f"{len(seen.copies)} copies; no synchronizing CUDA call before the end sync")
    check(all(b >= frame_bytes and b - frame_bytes < (2 ** 20 if i == 0 else 1)
              for i, b in enumerate(per_window[:distinct]))
          and all(b == 0 for b in per_window[distinct:]),
          f"ACE rollout: host-to-device bytes per window {per_window}, want {frame_bytes} for "
          f"the first {distinct} and 0 after (the upload cache)")
    ace["rollout"].update(h2d_bytes_per_window=per_window, window_bytes=frame_bytes)
    del out, stepper, agg, seen
    free()

    # (b) one window, the kernels against the plain path from the same
    # weights (erf gelu and two-pass norms, as the ACE loader builds every
    # checkpoint's network), on ace_bench's data
    ex = dict(size, exact=True, device=device)
    steppers = {}
    for dtype in ("float32", "bfloat16", "float16"):
        for kernels in (True, False):
            st = main_path.build_ace(dtype=dtype, kernels=kernels, **ex)
            if steppers:
                st.module.load_state_dict(next(iter(steppers.values())).module.state_dict())
            steppers[(dtype, kernels)] = st
    win = main_path.AceBenchSource(names, T + 1, ACE_SHAPE, seed=1)
    data = {n: torch.from_numpy(v[None]).to(dev) for n, v in win.read_window(0, T + 1,
                                                                               names).items()}
    outs = {}
    for key, st in steppers.items():
        zero_counts()
        outs[key] = st.run_on_batch(data, T)
        sync()
        c = counts()
        want = T * L if key[1] else 0
        check(c["K1"] == c["K3"] == want and c["K2"] == c["K4"] == 0,
              f"ACE window {key}: launches {c}")
    out_names = list(steppers[("float32", True)].cfg.out_names)

    def gap(a, b):
        return max(rel(outs[a].gen_data_norm[n], outs[b].gen_data_norm[n]) for n in out_names)

    f32_gap = gap(("float32", True), ("float32", False))
    bf_k, bf_p = gap(("bfloat16", True), ("float32", False)), gap(("bfloat16", False),
                                                                  ("float32", False))
    log(f"ACE window, {T} steps, the generated fields (normalized): float32 kernels against "
        f"the plain path max gap {f32_gap:.3e} of each field's largest value (tolerance 1e-4); "
        f"bf16 against float32 plain: kernels {bf_k:.3e}, plain path {bf_p:.3e} (ratio "
        f"{bf_k / bf_p:.3f}, at most {BF16_TAIL_VS_PLAIN})")
    check(f32_gap <= 1e-4, "ACE window: float32 kernels disagree with the plain path")
    check(bf_k <= BF16_TAIL_VS_PLAIN * bf_p, "ACE window: bf16 kernels off the plain path")
    # (g) float16 (K1 float32, K3's float16 instance): phase 23's rule
    f16_k, f16_p = gap(("float16", True), ("float32", False)), gap(("float16", False),
                                                                   ("float32", False))
    log(f"ACE window (g), float16 against float32 plain: kernels {f16_k:.3e}, plain path "
        f"{f16_p:.3e} (ratio {f16_k / f16_p:.3f}, at most {F16_WINDOW_VS_PLAIN})")
    check(f16_k <= F16_WINDOW_VS_PLAIN * f16_p, "ACE window: float16 kernels off the plain path")
    ace["window"] = dict(f32_rel=f32_gap, bf16_kernels_rel=bf_k, bf16_plain_rel=bf_p,
                         f16_kernels_rel=f16_k, f16_plain_rel=f16_p)

    # (c) the physics on the card: each step's global mean of dry-air
    # surface pressure equals its input's, and the surface temperature is
    # the target's where the mask rounds to 1. Tolerance in Pa: the float32
    # step at 1e5 Pa is 0.0078 Pa; the emitted surface pressure is
    # normalized and denormalized (one step), the correction's arithmetic
    # rounds about two, and each of the two global means loses at most
    # log2(64,800) = 16 roundings of half a step (0.0039 Pa) in torch's
    # pairwise sums: 3 x 0.0078 + 2 x 16 x 0.0039 = 0.148 Pa.
    dry_tol = 0.15
    sigma, area = steppers[("float32", True)].sigma, steppers[("float32", True)].area
    worst, sst_ok, finite = 0.0, True, True
    for key in (("float32", True), ("bfloat16", True), ("float16", True)):
        gen = outs[key].gen_data
        finite &= all(bool(torch.isfinite(v).all()) for v in gen.values())
        for t in range(1, T + 1):
            g = weighted_mean(ClimateData({n: v[:, t] for n, v in gen.items()})
                              .surface_pressure_due_to_dry_air(sigma), area, dim=(-2, -1))
            i = weighted_mean(ClimateData({n: v[:, t - 1] for n, v in data.items()})
                              .surface_pressure_due_to_dry_air(sigma), area, dim=(-2, -1))
            worst = max(worst, float((g.double() - i.double()).abs().max()))
        region = torch.round(data[main_path.MASK_NAME][:, 1:]).to(torch.int32) == 1
        sst_ok &= torch.equal(gen["surface_temperature"][:, 1:][region],
                              data["surface_temperature"][:, 1:][region])
    log(f"ACE physics on the card, float32, bf16 and float16 windows: the global mean of dry-air "
        f"surface pressure moved at most {worst:.4f} Pa from the input's in any step (tolerance "
        f"{dry_tol} Pa); the surface temperature equals the target inside the ocean: {sst_ok}; "
        f"every field finite: {finite}")
    check(worst <= dry_tol and sst_ok and finite, "ACE physics: dry air, ocean or finiteness")
    ace["physics"] = dict(dry_air_max_pa=worst, dry_air_tol_pa=dry_tol, sst_exact=sst_ok)
    f32k = steppers.pop(("float32", True))
    del steppers, outs, data
    free()

    # (d) a native ACE checkpoint of (b)'s float32 kernel stepper, in the
    # reference's names and with only the reference builder's keys, read
    # back by run_inference (stepper_type ace); the run config's model
    # overrides turn K1 and K3 on, as a user would for a published
    # checkpoint. On the synthetic source's O(1) fields the run config's
    # sigma (ak 0, bk to 0.1) keeps the dry-air correction's denominator
    # near 1.
    m = f32k.module
    state = ace_native_state(f32k, ACE_SHAPE)
    sg = {"ak": [0.0] * (ACE_LEVELS + 1), "bk": list(np.linspace(0.0, 0.1, ACE_LEVELS + 1))}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ace_") as tmp:
        path = os.path.join(tmp, "ace.ckpt")
        t0 = time.perf_counter()
        torch.save({"stepper": state}, path)
        write_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        t0 = time.perf_counter()
        loaded, _ = interface.load_ace_stepper_checkpoint(path, device=device)
        sync()
        load_s = time.perf_counter() - t0
        check(all(torch.equal(loaded.module.state_dict()[k], v)
                  for k, v in m.state_dict().items()), "ACE checkpoint: the weights differ")
        del loaded
        recorded = []
        real_run = SingleStepStepper.run_on_batch

        def recording(self, *a, **k):
            res = real_run(self, *a, **k)
            recorded.append(res)
            return res

        SingleStepStepper.run_on_batch = recording
        zero_counts()
        try:
            t0 = time.perf_counter()
            res = main_from_config({"checkpoint_path": path, "stepper_type": "ace",
                                    "n_forward_steps": T, "forward_steps_in_memory": T,
                                    "verbose": False, "log_zonal_mean_images": False,
                                    "experiment_dir": os.path.join(tmp, "out"),
                                    "sigma_coordinates": sg, "platform": device,
                                    "overrides": {"model": {"use_pallas": True,
                                                            "fused_tail": True}}})
            sync()
            cli_s = time.perf_counter() - t0
        finally:
            SingleStepStepper.run_on_batch = real_run
    cli_launches = counts()
    check(cli_launches["K1"] == cli_launches["K3"] == T * L and len(recorded) == 1,
          f"ACE command line: launches {cli_launches}, {len(recorded)} windows")
    syn = SyntheticTimeSeries(names, n_timesteps=T + 1, spatial_shape=ACE_SHAPE)
    sdata = {n: torch.from_numpy(v[None]).to(dev) for n, v in syn.read_window(
        0, T + 1, names).items()}
    ref = SingleStepStepper(f32k.cfg, f32k.model_fn, f32k.normalizer, f32k.area,
                            sigma=SigmaCoordinates.from_dict(sg), device=device,
                            module=f32k.module).run_on_batch(sdata, T, lean=True)
    ckpt_gap = max(rel(recorded[0].gen_data[n], ref.gen_data[n]) for n in out_names)
    rate = res["summary"]["total_steps_per_second"]
    log(f"ACE native checkpoint: {nbytes / 1e9:.3f} GB written in {write_s:.2f} s, loaded in "
        f"{load_s:.2f} s (gelu_exact, exact_norm, weights equal bit for bit; K1 and K3 from "
        f"the run config's overrides['model']); run_inference stepper_type ace, {T} steps: {cli_s:.2f} s with the "
        f"load, {rate:.3f} steps/s, K1 {cli_launches['K1']} and K3 {cli_launches['K3']} "
        f"launches; its fields against (b)'s float32 kernel stepper on the same frames: max gap "
        f"{ckpt_gap:.3e} of each field's largest value (tolerance 1e-5)")
    check(ckpt_gap <= 1e-5, "ACE checkpoint: the command line's fields differ")
    runs["ace_cli"] = dict(launches=cli_launches)
    ace["checkpoint"] = dict(bytes=nbytes, write_s=write_s, load_s=load_s, cli_s=cli_s,
                             steps_per_second=rate, rel=ckpt_gap)
    del f32k, m, state, recorded, ref, res, sdata
    free()

    # (e) simultaneous training: horizon 2, horizon_at_once 1, float32, K1
    live_gb = torch.cuda.memory_allocated() / 1e9 if cuda else 0.0
    zero_counts()
    sim = main_path.simultaneous_steps(n_steps=SIM_WARMUP + SIM_STEPS, horizon=2,
                                       horizon_at_once=1, device=device, embed=ACE_EMBED,
                                       layers=L, img_shape=ACE_SHAPE)
    c = counts()
    steps_ms = sim["step_ms"][SIM_WARMUP:]
    med = statistics.median(steps_ms)
    split = {p: statistics.median(s[p] for s in sim["split_ms"][SIM_WARMUP:])
             for p in sim["split_ms"][0]}
    peak_gb = sim["peak_bytes"] / 1e9 if sim["peak_bytes"] is not None else float("nan")
    k1_fwd = [a - b for a, b in zip(sim["k1_launches"], sim["k1_dx"])]
    log(f"simultaneous training (horizon 2, horizon_at_once 1: two autoregressive forwards a "
        f"step), {SIM_STEPS} steps after {SIM_WARMUP}: median {med:.2f} ms a step "
        f"({1e3 / med:.3f} steps/s), split {({k: round(v, 2) for k, v in split.items()})} ms, "
        f"peak {peak_gb:.3f} GB ({live_gb:.3f} GB live before); K1 per step {k1_fwd} forward and "
        f"{sim['k1_dx']} dx, images {sim['k1_images']}; K2-K4 {[c[k] for k in ('K2', 'K3', 'K4')]}"
        f"; losses {[round(v, 5) for v in sim['losses']]} on {smi_line}")
    check(all(v == 2 * L for v in k1_fwd) and all(v == 2 * L for v in sim["k1_dx"])
          and c["K2"] == c["K3"] == c["K4"] == 0 and all(np.isfinite(sim["losses"])),
          "simultaneous training: K1 counts, another kernel launched, or a loss not finite")
    runs["simultaneous"] = dict(launches=c)
    ace["simultaneous"] = dict(step_ms=med, steps_ms=steps_ms, split_ms=split, peak_gb=peak_gb,
                               live_gb_before=live_gb, k1_forward=k1_fwd, k1_dx=sim["k1_dx"],
                               losses=sim["losses"])
    del sim
    free()
    # the kernels against the plain path: SIM_CMP_STEPS steps at constant lr
    trs = [main_path.build_simultaneous(use_pallas=kernels, scheduler="constant",
                                        n_samples=SIM_CMP_STEPS, device=device,
                                        embed=ACE_EMBED, layers=L, img_shape=ACE_SHAPE)
           for kernels in (True, False)]
    trs[1].exp.model.load_state_dict(trs[0].exp.model.state_dict())
    losses = []
    for tr in trs:
        losses.append(main_path.train_steps(SIM_CMP_STEPS, trainers={"s": tr})["s"]["losses"])
        tr.exp.model.cpu()  # the next trainer's peak without this one's weights
        free()
    l_rel = max(abs(a - b) / abs(b) for a, b in zip(*losses))
    log(f"simultaneous training, {SIM_CMP_STEPS} steps at constant lr through the kernels and "
        f"through the plain path from the same weights and batches: losses max gap {l_rel:.3e} "
        f"relative (tolerance 1e-5)")
    check(l_rel <= 1e-5, "simultaneous training: the kernels disagree with the plain path")
    ace["simultaneous"].update(cmp_steps=SIM_CMP_STEPS, cmp_loss_rel=l_rel)
    del trs
    free()

    # (e) in float16: compute_dtype and sht_matmul_dtype float16 (K1 float32
    # whatever the compute dtype), SIM_STEPS steps after SIM_WARMUP through K1
    # at constant lr; the first step's loss against the float32 plain path's
    # from the same weights and batch, within F16_WINDOW_VS_PLAIN times the
    # float16 plain path's own gap (phase 23's rule) or within the 1e-5
    # relative that holds the kernels' loss to the plain path's in float32
    # (above): the untrained network's float16 rounding averages out of a
    # mean over 2.3 M elements below the loss's float32 rounding (the two
    # float16 losses stood 1 and 2 float32 spacings off), so the float16 rule
    # alone would hold float32 summation noise. Every gradient finite. Neither
    # package scales the loss, so a float16 backward at this size underflows:
    # the loss's gradient a element (1 / 2.3 M) times the decoder's weights
    # falls under float16's smallest subnormal, and the layers below the
    # decoder get zero gradients (JAX's float16 step alike, on the CPU at 90 x
    # 180); the parameter tensors whose float16 gradient is all zero where
    # float32's is not are counted and reported
    sims, grads = {}, {}
    first = None
    real_grad = torch.autograd.grad

    def grab_first(*a, _out=None, **k):
        res = real_grad(*a, **k)
        if not _out:
            _out.extend(g.detach().float().clone() for g in res)
        return res

    for key, kernels, dtype, n in (("kernels float16", True, "float16", SIM_WARMUP + SIM_STEPS),
                                   ("plain float16", False, "float16", 1),
                                   ("plain float32", False, "float32", 1)):
        tr = main_path.build_simultaneous(use_pallas=kernels, dtype=dtype, scheduler="constant",
                                          n_samples=SIM_WARMUP + SIM_STEPS, device=device,
                                          embed=ACE_EMBED, layers=L, img_shape=ACE_SHAPE)
        if first is None:
            first = {k: v.detach().clone() for k, v in tr.exp.model.state_dict().items()}
        else:
            tr.exp.model.load_state_dict(first)
        zero_counts()
        grads[key] = []
        torch.autograd.grad = functools.partial(grab_first, _out=grads[key])
        try:
            sims[key] = main_path.train_steps(n, trainers={"s": tr})["s"]
        finally:
            torch.autograd.grad = real_grad
        sims[key]["launches"] = counts()
        tr.exp.model.cpu()
        del tr
        free()
    k16 = sims["kernels float16"]
    l32, lk, lp = (sims[k]["losses"][0] for k in ("plain float32", "kernels float16",
                                                  "plain float16"))
    f16_gap, f16_noise = abs(lk - l32), abs(lp - l32)
    loss_floor = 1e-5 * abs(l32)
    f16_ms = statistics.median(k16["step_ms"][SIM_WARMUP:])
    k1_fwd16 = [a - b for a, b in zip(k16["k1_launches"], k16["k1_dx"])]
    finite16 = all(bool(torch.isfinite(g).all()) for g in grads["kernels float16"])
    zeroed = {key: sum(bool((a == 0).all()) and not bool((b == 0).all())
                       for a, b in zip(grads[key], grads["plain float32"]))
              for key in ("kernels float16", "plain float16")}
    n_tensors = len(grads["plain float32"])
    log(f"simultaneous training in float16 (compute and transforms' operands; K1 float32), "
        f"{SIM_STEPS} steps after {SIM_WARMUP} through K1: step ms "
        f"{[round(v, 2) for v in k16['step_ms']]} (median {f16_ms:.2f} ms against float32's "
        f"{med:.2f}), losses {[round(v, 5) for v in k16['losses']]}, gradient norms "
        f"{[round(v, 5) for v in k16['grad_norms']]}; K1 per step {k1_fwd16} forward and "
        f"{k16['k1_dx']} dx; the first step's loss {lk:.7f} against the float32 plain path's "
        f"{l32:.7f}: gap {f16_gap:.3e}, the float16 plain path's own {f16_noise:.3e} (at most "
        f"{F16_WINDOW_VS_PLAIN} x that, or the float32 rule's 1e-5 relative, {loss_floor:.3e}); "
        f"gradients finite: {finite16}; parameter tensors whose float16 gradient is all zero "
        f"where float32's is not (the backward's underflow without loss scaling): kernels "
        f"{zeroed['kernels float16']}, plain path {zeroed['plain float16']} of {n_tensors} "
        f"on {smi_line}")
    check(finite16 and all(np.isfinite(k16["losses"])) and all(np.isfinite(k16["grad_norms"])),
          "simultaneous training in float16: a loss or a gradient is not finite")
    check(all(v == 2 * L for v in k1_fwd16) and all(v == 2 * L for v in k16["k1_dx"])
          and k16["launches"]["K2"] == k16["launches"]["K3"] == k16["launches"]["K4"] == 0,
          f"simultaneous training in float16: launches {k16['launches']}")
    check(f16_gap <= max(F16_WINDOW_VS_PLAIN * f16_noise, loss_floor),
          "simultaneous training in float16: the kernels' first loss is off the plain path")
    runs["simultaneous f16"] = dict(launches=k16["launches"])
    ace["simultaneous_f16"] = dict(step_ms=f16_ms, steps_ms=k16["step_ms"],
                                   losses=k16["losses"], grad_norms=k16["grad_norms"],
                                   loss_gap=f16_gap, plain_f16_gap=f16_noise,
                                   loss_f32_plain=l32, zero_grad_tensors=zeroed,
                                   n_tensors=n_tensors)
    del sims, k16, first, grads
    free()

    # (g) the float16 rollout: ace_rollout(dtype="float16"), two windows after
    # its warm-up, K1 (float32) and K3's float16 instance; its steady window
    # beside (a)'s bf16 one ((b) and (c) hold its window and dry air)
    r16 = main_path.ace_rollout(n_steps=2 * T, window=T, dtype="float16", kernels=True,
                                before_timed=zero_counts, device=device, **size)
    c16 = counts()
    ws16 = r16["window_seconds"]
    check(c16["K1"] == c16["K3"] == 2 * T * L and c16["K2"] == c16["K4"] == 0,
          f"ACE float16 rollout launches {c16}: want K1 = K3 = {T * L} a window")
    check(all(bool(torch.isfinite(v).all()) for v in r16["gen"].values())
          and all(np.isfinite(v) for v in r16["logs"].values()),
          "ACE float16 rollout: a field or a log is not finite")
    log(f"ACE rollout (g) in float16 (K1 + K3's float16 instance), {2 * T} steps: window seconds "
        f"on the device {[round(v, 4) for v in ws16]}, steady {T / ws16[-1]:.3f} steps/s against "
        f"(a)'s bf16 {T / ws[-1]:.3f}; K1 {c16['K1'] // 2} and K3 {c16['K3'] // 2} launches a "
        f"window on {smi_line}")
    runs["ace f16"] = dict(launches=c16)
    ace["float16"] = dict(window_seconds=ws16, steady_steps_per_second=T / ws16[-1],
                          bf16_steady_steps_per_second=T / ws[-1], launches=c16,
                          kernels_rel=f16_k, plain_rel=f16_p)
    del r16
    free()

    # (h) the slab ocean through run_inference: a native checkpoint of
    # build_ace(slab=True)'s float32 network (its outputs hold the six
    # surface fluxes the slab reads), the run config's ocean.slab, T steps
    # over a netCDF file of AceBenchSource frames with the mixed-layer depth
    # and Q-flux; with K1 and K3 (overrides["model"]) against the plain path
    # (1e-4 of each field's largest value), and each step's surface
    # temperature over the ocean against the slab tendency in float64
    from spherical_dyffusion_tpu_torch.data.hdf5 import write_hdf5
    from spherical_dyffusion_tpu_torch.inference.ocean import mixed_layer_temperature_tendency

    slab_st = main_path.build_ace(dtype="float32", kernels=False, exact=True, slab=True,
                                  device=device, **size)
    slab_names = list(slab_st.cfg.all_names)
    frames = main_path.AceBenchSource(slab_names, T + 1, ACE_SHAPE, seed=2).read_window(
        0, T + 1, slab_names)
    slab_fields = dict(zip(("mixed_layer_depth_name", "q_flux_name"), main_path.SLAB_FIELDS))
    recorded = {}
    real_run = SingleStepStepper.run_on_batch
    with tempfile.TemporaryDirectory(prefix="chip_smoke_slab_") as tmp:
        path = os.path.join(tmp, "ace_slab.ckpt")
        torch.save({"stepper": ace_native_state(slab_st, ACE_SHAPE)}, path)
        data_dir = os.path.join(tmp, "data")
        os.makedirs(data_dir)
        H, W = ACE_SHAPE
        write_hdf5(os.path.join(data_dir, "slab.nc"),
                   dict(frames, lat=np.linspace(-89.5, 89.5, H), lon=np.linspace(0, 359, W)))
        del slab_st
        free()
        slab_launches, slab_s = {}, {}
        for key, over in (("kernels", {"model": {"use_pallas": True, "fused_tail": True}}),
                          ("plain", None)):
            runs_of = recorded.setdefault(key, [])

            def recording(self, *a, _runs=runs_of, **k):
                res = real_run(self, *a, **k)
                _runs.append(res)
                return res

            SingleStepStepper.run_on_batch = recording
            zero_counts()
            try:
                t0 = time.perf_counter()
                res = main_from_config({
                    "checkpoint_path": path, "stepper_type": "ace", "n_forward_steps": T,
                    "forward_steps_in_memory": T, "verbose": False,
                    "log_zonal_mean_images": False, "platform": device,
                    "experiment_dir": os.path.join(tmp, key),
                    "validation_loader": {"dataset": {"data_path": data_dir}},
                    "ocean": {"surface_temperature_name": "surface_temperature",
                              "ocean_fraction_name": main_path.MASK_NAME, "slab": slab_fields},
                    **({"overrides": over} if over else {})})
                sync()
                slab_s[key] = time.perf_counter() - t0
            finally:
                SingleStepStepper.run_on_batch = real_run
            slab_launches[key] = counts()
            check(res["stepper"].ocean.type == "slab" and len(runs_of) == 1,
                  f"ACE slab ({key}): ocean {res['stepper'].ocean.type}, {len(runs_of)} windows")
            check(all(np.isfinite(v) for v in res["logs"].values()),
                  f"ACE slab ({key}): a log is not finite")
            del res
    gk, gp = recorded["kernels"][0].gen_data, recorded["plain"][0].gen_data
    slab_gap = max(rel(gk[n], gp[n]) for n in gp)
    check(slab_launches["kernels"]["K1"] == slab_launches["kernels"]["K3"] == T * L
          and sum(slab_launches["plain"].values()) == 0,
          f"ACE slab launches {slab_launches}")
    check(slab_gap <= 1e-4, "ACE slab: the kernels disagree with the plain path")
    # the step's update over the ocean: input (frame t - 1) + the tendency of
    # the generated fluxes and the target's Q-flux and depth over 6 hours
    sst = "surface_temperature"
    gen = {n: v[0].double().cpu() for n, v in gk.items()}
    f64 = {n: torch.from_numpy(v).double() for n, v in frames.items()}
    spacing = 4 * float(np.spacing(np.float32(np.abs(frames[sst]).max())))
    sst_err, moved = 0.0, 0.0
    for t in range(1, T + 1):
        flux = (gen["DLWRFsfc"][t] - gen["ULWRFsfc"][t] + gen["DSWRFsfc"][t]
                - gen["USWRFsfc"][t] - gen["LHTFLsfc"][t] - gen["SHTFLsfc"][t])
        want = f64[sst][t - 1] + mixed_layer_temperature_tendency(
            flux, f64[main_path.SLAB_FIELDS[1]][t], f64[main_path.SLAB_FIELDS[0]][t]) * 21600.0
        ocean = torch.round(f64[main_path.MASK_NAME][t]) == 1
        sst_err = max(sst_err, float((gen[sst][t] - want)[ocean].abs().max()))
        moved = max(moved, float((want - f64[sst][t - 1])[ocean].abs().max()))
    log(f"ACE slab ocean (h) through run_inference (the run config's ocean.slab; K1 and K3 from "
        f"overrides['model']), {T} steps: K1 {slab_launches['kernels']['K1']} and K3 "
        f"{slab_launches['kernels']['K3']} launches; fields against the plain path max gap "
        f"{slab_gap:.3e} of each field's largest value (tolerance 1e-4); the surface "
        f"temperature over the ocean against the float64 slab update: max error {sst_err:.3e} K "
        f"(tolerance 4 float32 spacings, {spacing:.3e} K), the update at most {moved:.3e} K; "
        f"{slab_s['kernels']:.2f} s with the load (plain path {slab_s['plain']:.2f} s) on "
        f"{smi_line}")
    check(sst_err <= spacing and moved > 100 * spacing,
          "ACE slab: the surface temperature over the ocean is not the slab update")
    runs["ace slab"] = dict(launches=slab_launches["kernels"])
    ace["slab"] = dict(steps=T, rel=slab_gap, sst_err_k=sst_err, sst_tol_k=spacing,
                       sst_update_max_k=moved, launches=slab_launches["kernels"])
    del recorded, gk, gp, gen, f64, frames
    free()

    # (f) where an ACE window's time goes: one warm window of (a)'s path
    # under torch.profiler, its kernel time grouped as phase 9 groups it,
    # against (a)'s steady window seconds (the unprofiled yardstick)
    from torch.profiler import ProfilerActivity, profile

    st = main_path.build_ace(dtype="bfloat16", kernels=True, device=device, **size)
    src = main_path.AceBenchSource(names, T + 1, ACE_SHAPE)
    run_ace_inference(st, src, T, T, verbose=False)
    agg = InferenceAggregator(ace_scored_names(st, src, derived=True),
                              src.horizontal.area_weights(), log_zonal_mean_images=False)
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        prof_summary = run_ace_inference(st, src, T, T, aggregator=agg, derived=True,
                                         verbose=False)
    events = [e for e in prof.key_averages()
              if "cuda" in str(getattr(e, "device_type", "")).lower()]
    groups, n_launch = {}, 0
    for e in events:
        key = e.key
        us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
        group = ("K1" if "dhconv" in key and "image" not in key else
                 "K1 weight image" if "dhconv_weight_image" in key else
                 "K3" if re.search(r"fused_mlp(_tc)?_kernel<true", key) else
                 "K2/K3 weight repack" if "weight_image_kernel" in key else
                 "host-to-device copy" if "HtoD" in key else
                 "cuBLAS GEMM" if any(w in key.lower() for w in
                                      ("gemm", "nvjet", "xmma", "cutlass")) else
                 "copies" if "copy" in key.lower() else
                 "reductions" if "reduce" in key.lower() else "other elementwise")
        groups[group] = groups.get(group, 0.0) + us / 1e6
        n_launch += e.count
    busy = sum(groups.values())
    steady_window = ace["rollout"]["window_seconds"][-1]
    log(f"ACE window profile ({T} steps, bf16, K1 + K3, aggregator and diagnostics; the "
        f"window's upload inside): {len(events)} CUDA kernels, {n_launch} launches "
        f"({n_launch / T:.0f} a step), device time {busy:.3f} s = {busy / steady_window:.1%} of "
        f"(a)'s unprofiled steady window ({steady_window:.4f} s); host launching "
        f"{prof_summary['time/run_on_batch']:.3f} s with the profiler on; by group: " + ", ".join(
            f"{k} {v:.4f} s ({v / max(busy, 1e-12):.1%})"
            for k, v in sorted(groups.items(), key=lambda kv: -kv[1])))
    ace["profile"] = dict(kernels=len(events), launches=n_launch, device_s=busy,
                          steady_window_s=steady_window, groups=groups)
    del st, agg, prof
    free()
    report["ace"] = ace


def phase16(smi_line, wrappers, report, runs, device="cuda") -> None:
    """Phase 16: the UNet at the published width of ``configs/model/unet.json``
    (UNET_DIM, UNET_MULTS, dropouts 0.1, bilinear resampling UNET_SHAPE ->
    UNET_UPSAMPLE) in float32 at batch 1 with the main path's channels, cuDNN
    at torch's default (TF32 convolutions) as a user runs it: (a) each
    network's forward ms and peak memory, (b) a 12-step DYffusion window with
    the interpolator's dropout live, (c) training steps of both experiments,
    (d) the train command line with ``model=unet`` and ``run_inference``
    from its checkpoint; then (e) at debug size with dropout off and TF32
    off, the card's output against the CPU's for the same weights. The UNet
    has no hand-written kernel: K1-K4 launch no time in (a)-(d)."""
    import gc
    import statistics
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from spherical_dyffusion_tpu_torch import main_path
    from spherical_dyffusion_tpu_torch.models.unet import UNet, UNetConfig
    from spherical_dyffusion_tpu_torch.run_inference import main_from_config
    from spherical_dyffusion_tpu_torch.train import run_model

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    size = dict(img_shape=UNET_SHAPE, n_state=UNET_STATE)
    unet_kw = dict(dim=UNET_DIM, dim_mults=UNET_MULTS, upsample_dims=UNET_UPSAMPLE)
    rep = {"cudnn_allow_tf32": True}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # torch's default: what a user's run gets
    for fn in wrappers.values():
        fn.launches = 0

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def peak_gb():
        return torch.cuda.max_memory_allocated() / 1e9 if cuda else None

    def reset_peak():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    try:
        # (a) each network's forward: ms (CUDA events around UNET_REPS calls)
        # and the peak memory of one call above what was allocated before it
        stepper = main_path.build_unet(device=device, **size, **unet_kw)
        exp = stepper.exp
        for name, net in (("interpolator", exp.interpolator.model), ("forecaster", exp.model)):
            n_params = sum(p.numel() for p in net.parameters())
            c = net.cfg
            x = torch.randn((1,) + tuple(c.img_shape) + (c.in_chans,), device=dev)
            t = torch.ones(1, device=dev)
            with torch.no_grad():
                for _ in range(2):
                    y = net(x, time=t)
                sync()
                reset_peak()
                base = torch.cuda.memory_allocated() / 1e9 if cuda else None
                y = net(x, time=t)
                sync()
                peak = peak_gb()
                if cuda:
                    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                    ev[0].record()
                    for _ in range(UNET_REPS):
                        net(x, time=t)
                    ev[1].record()
                    ev[1].synchronize()
                    ms = ev[0].elapsed_time(ev[1]) / UNET_REPS
                else:
                    t0 = time.perf_counter()
                    net(x, time=t)
                    ms = (time.perf_counter() - t0) * 1e3
            check(tuple(y.shape) == (1,) + tuple(c.img_shape) + (c.out_chans,)
                  and bool(torch.isfinite(y).all()), f"UNet {name} forward: shape or finiteness")
            rep[name] = dict(params=n_params, in_chans=c.in_chans, forward_ms=ms,
                             peak_gb=peak, peak_above_live_gb=(peak - base) if cuda else None)
            log(f"UNet {name} ({c.in_chans} -> {c.out_chans} channels, {n_params / 1e6:.3f} M "
                f"parameters): forward {ms:.3f} ms (mean of {UNET_REPS}, CUDA events), peak "
                f"{peak if peak is None else round(peak, 3)} GB ({rep[name]['peak_above_live_gb']}"
                f" GB above the live weights); on {smi_line}")
            del x, y
        if UNET_DIM == 64 and UNET_MULTS == (1, 2, 4, 8):
            check(35.3e6 < rep["interpolator"]["params"] < 35.5e6,
                  f"the published UNet has 35.4 M parameters, got {rep['interpolator']['params']}")

        # (b) a 12-step window, horizon 6, the interpolator's dropout live
        w = main_path.unet_window(stepper, n_steps=N_STEPS)
        preds = w["preds"]
        check(tuple(preds.shape) == (1, N_STEPS) + tuple(UNET_SHAPE) + (UNET_STATE,)
              and bool(torch.isfinite(preds).all()) and bool(torch.isfinite(w["state"]).all()),
              f"UNet window: predictions {tuple(preds.shape)} or non-finite")
        check(w["forwards"]["interpolator"] > 0 and w["forwards"]["forecaster"] > 0,
              f"UNet window forwards {w['forwards']}")
        rep["window"] = dict(steps=N_STEPS, seconds=w["seconds"], steps_per_s=w["steps_per_s"],
                             forwards=w["forwards"])
        log(f"UNet window: {N_STEPS} steps in {w['seconds']:.3f} s = {w['steps_per_s']:.3f} "
            f"steps/s (after a warm-up window), forwards {w['forwards']}; on {smi_line}")
        del stepper, exp, w, preds
        reset_peak()
        # train_steps zeroes K1's count at every step and returns it per step
        launches = {k: fn.launches for k, fn in wrappers.items()}
        for fn in wrappers.values():
            fn.launches = 0

        # (c) training steps of both experiments
        tr = main_path.unet_train_steps(UNET_TRAIN_STEPS, device=device, **size, **unet_kw)
        launches["K1"] += sum(sum(r["k1_launches"]) for r in tr.values())
        wrappers["K1"].launches = 0
        rep["training"] = {}
        for name, r in tr.items():
            check(all(np.isfinite(r["losses"])), f"UNet {name} training: a non-finite loss")
            warm = r["step_ms"][1:] or r["step_ms"]
            rep["training"][name] = dict(
                step_ms=r["step_ms"], median_step_ms=statistics.median(warm),
                losses=r["losses"], split_ms=r["split_ms"],
                peak_gb=r["peak_bytes"] / 1e9 if r["peak_bytes"] is not None else None)
            log(f"UNet {name} training: step ms {[round(v, 2) for v in r['step_ms']]} (median "
                f"after the first {statistics.median(warm):.2f}), losses "
                f"{[round(v, 5) for v in r['losses']]}, peak "
                f"{rep['training'][name]['peak_gb']} GB; on {smi_line}")
        del tr
        reset_peak()

        # (d) the train command line with model=unet, 2 steps of each
        # experiment, then run_inference from the forecaster's checkpoint
        tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_unet_")
        d = Path(tmp.name)
        H, W = UNET_SHAPE
        common = [f"ckpt_dir={d}", f"++log_dir={d / 'logs'}", "trainer.epochs=1",
                  "++trainer.steps_per_epoch=2", "datamodule.n_timesteps=8",
                  f"datamodule.height={H}", f"datamodule.width={W}",
                  f"datamodule.channels={UNET_STATE}", "datamodule.n_forcing=2",
                  "datamodule.batch_size=1", "++datamodule.max_val_samples=1",
                  "++trainer.num_predictions=2", "model=unet", f"model.dim={UNET_DIM}",
                  f"model.dim_mults={list(UNET_MULTS)}",
                  f"model.upsample_dims={list(UNET_UPSAMPLE)}", "verbose=false"]
        if device == "cpu":
            common.append("platform=cpu")
        cli = {}
        t0 = time.perf_counter()
        ip = run_model(None, ["experiment=debug_interpolation"] + common)
        cli["interpolator_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        fc = run_model(None, ["experiment=debug_dyffusion",
                              f"diffusion.interpolator_checkpoint_path={ip['ckpt_path']}"]
                       + common)
        cli["forecaster_s"] = time.perf_counter() - t0
        for name, run in (("interpolator", ip), ("forecaster", fc)):
            model = run["trainer"].exp.model
            check(isinstance(model, UNet) and model.cfg.upsample_dims == tuple(UNET_UPSAMPLE),
                  f"train command line {name}: model=unet built {type(model).__name__}")
            losses = run["history"]["step_losses"]
            check(len(losses) == 2 and all(np.isfinite(losses)),
                  f"train command line {name}: steps {losses}")
            cli[name] = dict(losses=losses, ckpt_bytes=os.path.getsize(run["ckpt_path"]))
        del ip, fc
        reset_peak()
        t0 = time.perf_counter()
        out = main_from_config({"checkpoint_path": str(d / "debug-dyffusion_last.ckpt"),
                                "n_forward_steps": N_STEPS, "forward_steps_in_memory": N_STEPS,
                                "experiment_dir": str(d / "inference"),
                                "log_zonal_mean_images": False, "verbose": False,
                                **({"platform": "cpu"} if device == "cpu" else {})})
        cli["inference_wall_s"] = time.perf_counter() - t0
        summary = out["summary"]
        metrics = json.loads((d / "inference" / "metrics.json").read_text())
        logs = {k: v for k, v in metrics.items() if k.startswith("inference/")}
        bad = [k for k, v in logs.items() if not np.isfinite(v)]
        check(isinstance(out["stepper"].exp.model, UNet) and len(logs) > 20 and not bad
              and metrics["n_forward_steps"] == N_STEPS,
              f"run_inference from the UNet checkpoint: {len(logs)} metrics, non-finite {bad[:4]}")
        cli["inference"] = dict(steps=N_STEPS, duration_s=summary["duration_s"],
                                total_steps_per_second=summary["total_steps_per_second"])
        rep["cli"] = cli
        log(f"UNet command lines: train model=unet interpolator {cli['interpolator_s']:.2f} s, "
            f"forecaster {cli['forecaster_s']:.2f} s (built, 2 steps, validated, saved; "
            f"checkpoints {cli['interpolator']['ckpt_bytes'] / 1e9:.3f} and "
            f"{cli['forecaster']['ckpt_bytes'] / 1e9:.3f} GB), losses "
            f"{cli['interpolator']['losses']} / {cli['forecaster']['losses']}; run_inference "
            f"{N_STEPS} steps: {summary['duration_s']:.3f} s, "
            f"{summary['total_steps_per_second']:.3f} steps/s; on {smi_line}")
        del out
        tmp.cleanup()
        launches = {k: launches[k] + fn.launches for k, fn in wrappers.items()}
        runs["unet"] = dict(launches=launches)
        check(not any(launches.values()), f"the UNet path launched a port kernel: {launches}")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32

    # (e) debug size, dropout off, TF32 off: the card against the CPU
    torch.backends.cudnn.allow_tf32 = False
    try:
        cfg = UNetConfig(img_shape=(45, 90), in_chans=5, out_chans=3, dim=8, dim_mults=(1, 2, 4),
                         with_time_emb=True, outer_sample_mode="bilinear", upsample_dims=(48, 96),
                         block_dropout=0.0, block_dropout1=0.0, attn_dropout=0.0)
        cpu_net = UNet(cfg)
        cpu_net.init_weights(torch.Generator().manual_seed(0))
        net = UNet(cfg).to(dev)
        net.load_state_dict(cpu_net.state_dict())
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.standard_normal((2, 45, 90, 5)).astype(np.float32))
        t = torch.tensor([1.0, 3.0])
        with torch.no_grad():
            want = cpu_net(x, time=t)
            got = net(x.to(dev), time=t.to(dev)).cpu()
        gap = float((got - want).abs().max() / want.abs().max())
        rep["card_vs_cpu"] = dict(rel_gap=gap, tolerance=1e-4)
        log(f"UNet at debug size (45 x 90, bilinear 48 x 96), dropout off, TF32 off: the card "
            f"against the CPU, max gap {gap:.3e} of the largest output (tolerance 1e-4)")
        check(gap <= 1e-4, f"UNet on the card differs from the CPU by {gap:.3e}")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    report["unet"] = rep


def phase17(smi_line, wrappers, report, runs, device="cuda") -> None:
    """Phase 17: the parallel path on one card. ``maybe_init_multihost``
    with ``SPHDY_COORDINATOR`` at a free local port, one process, rank 0: an
    NCCL group of one ("gloo" on the CPU); ``distributed_sht``, ``isht`` and
    ``dhconv`` (scatter on and off) at PAR_CHANNELS channels on PAR_SHAPE
    against ``ops/sht.py``'s transforms and the dense contraction (1e-5
    relative), each collective a call of NCCL's; PAR_STEPS training steps of
    the interpolator at PAR_EMBED x PAR_LAYERS through K1 with
    ``grad_reduce_dtype="bfloat16"`` and ``zero_shard_opt_state=True``
    against the plain trainer's, bit for bit (a mesh of one rank skips both,
    as JAX skips them at mesh size 1), K1's launches counted; the group
    destroyed."""
    import dataclasses
    import socket

    import torch
    import torch.distributed as dist

    from spherical_dyffusion_tpu_torch import main_path
    from spherical_dyffusion_tpu_torch.ops.contractions import contract_dhconv
    from spherical_dyffusion_tpu_torch.ops.sht import InverseRealSHT, RealSHT
    from spherical_dyffusion_tpu_torch.parallel.distributed_sht import (
        distributed_dhconv,
        distributed_isht,
        distributed_sht,
    )
    from spherical_dyffusion_tpu_torch.parallel.mesh import make_mesh
    from spherical_dyffusion_tpu_torch.parallel.multihost import maybe_init_multihost
    from spherical_dyffusion_tpu_torch.training.trainer import Trainer

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    rep = {}
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {"SPHDY_COORDINATOR": f"127.0.0.1:{port}", "SPHDY_NUM_PROCESSES": "1",
           "SPHDY_PROCESS_ID": "0"}
    t0 = time.perf_counter()
    spec = maybe_init_multihost(env=env, backend="nccl" if cuda else "gloo")
    try:
        rep["init_s"] = time.perf_counter() - t0
        backend = dist.get_backend()
        check(spec is not None and dist.is_initialized() and dist.get_world_size() == 1
              and backend == ("nccl" if cuda else "gloo"),
              f"maybe_init_multihost: {spec}, backend {backend}")
        mesh = make_mesh(data=1, h=1, w=1)
        check(all(g is dist.group.WORLD for g in mesh.groups.values()),
              "a world of one: every mesh axis should run its collectives on the world group")

        def timed_ms(fn):
            fn()
            if not cuda:
                return None
            torch.cuda.synchronize()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            for _ in range(3):
                fn()
            ev[1].record()
            ev[1].synchronize()
            return ev[0].elapsed_time(ev[1]) / 3

        H, W = PAR_SHAPE
        C = PAR_CHANNELS
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn((1, H, W, C), generator=gen, device=dev)
        wt = torch.randn((C, C, H, 2), generator=gen, device=dev) / C
        sht, isht = RealSHT(H, W).to(dev), InverseRealSHT(H, W).to(dev)
        want = sht(x)
        cases = {
            "sht": (lambda: distributed_sht(x, sht, mesh), lambda: want, lambda: sht(x)),
            "isht": (lambda: distributed_isht(want, isht, mesh), lambda: isht(want),
                     lambda: isht(want)),
            "dhconv": (lambda: distributed_dhconv(want, wt, mesh),
                       lambda: contract_dhconv(want, wt), lambda: contract_dhconv(want, wt)),
            "dhconv_all_reduce": (lambda: distributed_dhconv(want, wt, mesh,
                                                             scatter_output=False),
                                  lambda: contract_dhconv(want, wt),
                                  lambda: contract_dhconv(want, wt)),
        }
        for name, (fn, ref, plain) in cases.items():
            got, r = fn(), ref()
            gap = float((got - r).abs().max() / r.abs().max())
            rep[name] = dict(rel_gap=gap, ms=timed_ms(fn), single_device_ms=timed_ms(plain))
            log(f"distributed {name} at {C} channels on {H} x {W} over an {backend} group of "
                f"one: {tuple(got.shape)}, max gap {gap:.3e} of the largest value (tolerance "
                f"1e-5), {rep[name]['ms']} ms against the single-device "
                f"{rep[name]['single_device_ms']} ms; on {smi_line}")
            check(gap <= 1e-5, f"distributed {name} differs from the single-device transform")
        del x, wt, want

        # training through K1: the plain trainer, then bf16 gradient mean
        # and ZeRO-1 from the same weights (skipped on a mesh of one rank)
        tr = main_path.build_training(PAR_EMBED, PAR_LAYERS, PAR_SHAPE, n_samples=PAR_STEPS,
                                      forecaster=False, device=device)["interpolator"]
        init = {k: v.detach().clone() for k, v in tr.exp.model.state_dict().items()}
        plain = main_path.train_steps(PAR_STEPS, trainers={"plain": tr})["plain"]
        tr.exp.model.load_state_dict(init)
        cfg = dataclasses.replace(tr.cfg, grad_reduce_dtype="bfloat16",
                                  zero_shard_opt_state=True)
        par_tr = Trainer(tr.exp, tr.dm, cfg)
        check(par_tr.mesh.size == 1, f"the trainer's mesh {par_tr.mesh.shape}")
        for fn in wrappers.values():
            fn.launches = 0
        par = main_path.train_steps(PAR_STEPS, trainers={"parallel": par_tr})["parallel"]
        # train_steps zeroes K1's count at every step and returns it per step
        launches = {k: fn.launches for k, fn in wrappers.items()}
        for fn in wrappers.values():
            fn.launches = 0
        launches["K1"] = sum(par["k1_launches"])
        runs["parallel"] = dict(launches=launches)
        same = (par["losses"] == plain["losses"] and all(
            torch.equal(a, b) for a, b in zip(plain["state"].model.state_dict().values(),
                                              par["state"].model.state_dict().values())))
        rep["training"] = dict(steps=PAR_STEPS, losses=par["losses"],
                               plain_losses=plain["losses"], bit_for_bit=same,
                               step_ms=par["step_ms"], plain_step_ms=plain["step_ms"],
                               k1_launches=launches["K1"])
        log(f"training at {PAR_EMBED} x {PAR_LAYERS} through K1 with grad_reduce_dtype "
            f"bfloat16 and ZeRO-1 on a world of one: losses {par['losses']} against the plain "
            f"trainer's {plain['losses']}, parameters bit for bit: {same}; K1 launched "
            f"{launches['K1']} x; step ms {[round(v, 2) for v in par['step_ms']]} (plain "
            f"{[round(v, 2) for v in plain['step_ms']]}); on {smi_line}")
        check(same, "the parallel trainer on a world of one differs from the plain trainer")
        check(launches["K1"] > 0 and par["k1_launches"] == plain["k1_launches"],
              f"the parallel training steps launched K1 {par['k1_launches']} times a step, the "
              f"plain trainer's {plain['k1_launches']}")
    finally:
        dist.destroy_process_group()
    check(not dist.is_initialized(), "the process group outlived phase 17")
    report["parallel"] = rep


def phase21(smi_line, wrappers, report, runs, device="cuda") -> None:
    """Phase 21: spatial model parallelism on one card. Two ranks cannot
    share one card's NCCL communicator, so the multi-rank numerics are the
    gloo tests' (``tests/test_torch_port_parallel.py``); here the kernels
    run at the shard shapes and the spatial route at full width over an
    NCCL group of one. (a) K1 on the channel shards of "w" = 2 and 4 (CI =
    SPATIAL_EMBED / 2 and / 4, CO = SPATIAL_EMBED, (1, L, M)) against its
    plain version (float32, 1e-5), with its ms, bound and complex
    ``torch.matmul``'s ms. (b) K3 and K2 (bf16, batch 2, dropout 0.1) on
    the four blocks of h = 2, w = 2 and the two of h = 2, at their origins:
    each equal to the whole grid's launch restricted to the block in its
    dropped elements (and whether bit for bit), and to its plain version at
    the origin (1e-2); the ms at an origin beside the whole grid's. (c)
    Phase 7's fused-tail path (K1, K3, peeled sampler, ``scan_layers``,
    the interpolator's dropout live) with ``make_mesh(1, 1, 1)`` over the
    NCCL group of one attached to both SFNOs (``SFNO.set_mesh``: every
    transform, norm sum and reduce-scatter a call of NCCL's): a 12-step
    window against the same stepper's window without the mesh, from the
    same weights and seed (the same masks), within BF16_TAIL_VS_PLAIN of
    the route's own bf16 error (the float32 window from the same weights);
    K1 and K3 launched as on the window without the mesh; its seconds
    beside phase 7's. (d) K4 at the fast window's shape on the channel
    shards of "w" = 2 and 4 (2R/2 and 2R/4 columns, their columns of C)
    and on the "h" = 2 route (the whole analysis, each block's 90 synthesis
    rows), bf16 and float32, against its plain version, with its ms, its
    device ms, the plain version's and the bf16 ``torch.bmm`` chain's, and
    its bound, beside the whole grid's launch. (e) Phase 8's fast window
    on the route as (c): K4 launched 144 x both ways, its seconds beside
    phase 8's. (f) One float32 forward of each routed filter option (the
    XLA-form, merged, separable and diagonal filters, CP, Tucker and TT in
    spectral space, the CP and Tucker rank pipelines, K4 in float32,
    spectral attention shared and per degree, ``scale_factor``) at
    SPATIAL_EMBED x SPATIAL_LAYERS (the diagonal filters at
    OPT_DIAG_EMBED), and of the folded Legendre stage and the planar FFT
    transform through K1, with the mesh attached against the same model
    without it (1e-4), each making the collectives of its route and
    launching K1 as many times as its dense filters. (g) Phase 13's folded
    window (phase 7's path with ``sht_fold_symmetry``) on the route as (c):
    K1 and K3 launched 192 x both ways, its seconds beside phase 13's. With
    "h" at 1 a rank is its own mirror and a gather over "h" is one rank's,
    so the folded stage's mirror exchange and the FFT's "h" gather make no
    call here: their numerics over several ranks (mirror pairs, the equator
    block at odd "h", the gather's row order) are the gloo tests'
    (``tests/test_torch_port_spatial_options.py``). The group is
    destroyed."""
    import dataclasses
    import socket

    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from spherical_dyffusion_tpu_torch import main_path
    from spherical_dyffusion_tpu_torch.models.sfno import SFNO
    from spherical_dyffusion_tpu_torch.ops.fused_mlp import (
        fused_block_tail,
        fused_block_tail_plain,
        fused_mlp,
        fused_mlp_plain,
        weight_image,
    )
    from spherical_dyffusion_tpu_torch.ops.fused_rank import fused_rank, fused_rank_plain
    from spherical_dyffusion_tpu_torch.ops.pallas_contractions import (
        dhconv,
        dhconv_plain,
        dhconv_weight_image,
    )
    from spherical_dyffusion_tpu_torch.ops.sht import InverseRealSHT, RealSHT
    from spherical_dyffusion_tpu_torch.parallel.distributed_sht import mirror_pairs
    from spherical_dyffusion_tpu_torch.parallel.mesh import Block, make_mesh
    from spherical_dyffusion_tpu_torch.parallel.multihost import maybe_init_multihost

    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def timed_ms(fn, reps, spin=False):
        """ms a call of ``fn`` in a loop of ``reps`` between CUDA events;
        with ``spin``, the calls queued behind a spin kernel (``main``'s
        ``device_ms``: the device's time, without the host's work between
        launches)."""
        fn()
        if not cuda:
            return None
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        ev[0].record()
        for _ in range(reps):
            fn()
        ev[1].record()
        if spin:
            check(not ev[0].query(), "the device reached the timed launches before the host "
                                     "had queued them all; lengthen the spin")
        ev[1].synchronize()
        return ev[0].elapsed_time(ev[1]) / reps

    def rel(got, want):
        d = float((got.float() - want.float()).abs().max())
        return d, d / float(want.float().abs().max())

    rep = {}
    H, W = SPATIAL_SHAPE
    C = SPATIAL_EMBED
    g = torch.Generator(device=dev).manual_seed(21)

    # (a) K1 on the channel shards
    L, M = H, W // 2 + 1
    for CI in (C // 2, C // 4):
        x = torch.randn((1, L, M, CI, 2), generator=g, device=dev)
        w = torch.randn((CI, C, L, 2), generator=g, device=dev) / (CI * C) ** 0.5
        img = dhconv_weight_image(w)
        y = dhconv(x, w, img)
        sync()
        want = dhconv_plain(x, w)
        abs_err, rel_err = rel(y, want)
        xc = torch.view_as_complex(x)
        wc = torch.view_as_complex(w.permute(2, 0, 1, 3).contiguous())  # (L, CI, CO)
        flops = 8.0 * L * M * CI * C
        bound_ms, bound_by = bound(flops, 4.0 * (x.numel() + w.numel() + y.numel()), TF32_PEAK)
        k1 = dict(max_abs_err=abs_err, max_rel_err=rel_err, ms=timed_ms(lambda: dhconv(x, w, img), 20),
                  plain_ms=timed_ms(lambda: dhconv_plain(x, w), 5),
                  library_ms=timed_ms(lambda: torch.matmul(xc, wc), 20), bound_ms=bound_ms,
                  bound_by=bound_by, shape=[1, L, M, CI, C])
        log(f"K1 on a 'w' channel shard (1, {L}, {M}) x {CI} -> {C}: max abs err {abs_err:.3e}, "
            f"rel {rel_err:.3e} (tolerance 1e-5); kernel {k1['ms']} ms, plain {k1['plain_ms']} ms, "
            f"complex torch.matmul {k1['library_ms']} ms, bound {bound_ms:.4f} ms ({bound_by}) "
            f"on {smi_line}")
        check(rel_err <= 1e-5, f"K1 at CI = {CI} disagrees with its plain version")
        rep[f"K1_ci{CI}"] = k1
        del x, w, img, y, want, xc, wc
    report["K1"]["shard"] = {k: v for k, v in rep.items() if k.startswith("K1_")}

    # (b) K3 and K2 on the blocks, at their origins
    Hd = 2 * C
    x = torch.randn((2, H, W, C), generator=g, device=dev).bfloat16()
    a = 1.0 + 0.1 * torch.randn((2, 1, 1, C), generator=g, device=dev)
    c = 0.1 * torch.randn((2, 1, 1, C), generator=g, device=dev)
    w1 = torch.randn((C, Hd), generator=g, device=dev) / C ** 0.5
    b1 = 0.1 * torch.randn((Hd,), generator=g, device=dev)
    w2 = torch.randn((Hd, C), generator=g, device=dev) / Hd ** 0.5
    b2 = 0.1 * torch.randn((C,), generator=g, device=dev)
    w1b, w2b, b1b, b2b = w1.bfloat16(), w2.bfloat16(), b1.bfloat16(), b2.bfloat16()
    kw = dict(seed=20260121, drop_rate=0.1)
    kernel = {"K2": lambda xx, blk=None: fused_mlp(xx, w1, b1, w2, b2, block=blk, **kw),
              "K3": lambda xx, blk=None: fused_block_tail(xx, a, c, w1, b1, w2, b2, block=blk,
                                                          **kw)}
    plain = {"K2": lambda xx, blk: fused_mlp_plain(xx, w1, b1, w2, b2, block=blk, **kw),
             "K3": lambda xx, blk: fused_block_tail_plain(xx, a, c, w1, b1, w2, b2, block=blk,
                                                          **kw)}
    library = {"K2": lambda xx: F.gelu(xx @ w1b + b1b, approximate="tanh") @ w2b + b2b,
               "K3": lambda xx: F.gelu((xx.float() * a + c).bfloat16() @ w1b + b1b,
                                       approximate="tanh") @ w2b + b2b}
    hb, wb = H // 2, W // 2
    blocks = [Block(h0, w0, (hb, wb), (H, W)) for h0 in (0, hb) for w0 in (0, wb)]
    blocks += [Block(h0, 0, (hb, W), (H, W)) for h0 in (0, hb)]
    for k in ("K3", "K2"):
        whole = kernel[k](x)
        sync()
        bitwise, worst = [], 0.0
        for blk in blocks:
            xb = x[:, blk.rows(), blk.cols()].contiguous()
            y = kernel[k](xb, blk)
            sync()
            want = whole[:, blk.rows(), blk.cols()]
            p = plain[k](xb, blk)
            same = torch.equal(y == 0, want == 0) and torch.equal(y == 0, p == 0)
            bitwise.append(bool(torch.equal(y, want)))
            worst = max(worst, rel(y, p)[1])
            check(same, f"{k} at origin ({blk.h0}, {blk.w0}) of a {blk.local} block drops other "
                        f"elements than the whole grid's launch or its plain version")
            check(rel(y, p)[1] <= 1e-2, f"{k} at origin ({blk.h0}, {blk.w0}) disagrees with its "
                                        f"plain version")
            del y, want, p
        quarter = blocks[3]  # the h = 2, w = 2 block at (H/2, W/2)
        half = blocks[5]  # the h = 2 block at (H/2, 0)
        xq = x[:, quarter.rows(), quarter.cols()].contiguous()
        xh = x[:, half.rows(), half.cols()].contiguous()
        rows = xq.numel() // C
        nbytes = 2.0 * (2 * xq.numel() + w1.numel() + w2.numel()) + 4.0 * (Hd + C) + (
            8.0 * a.numel() if k == "K3" else 0.0)
        bound_ms, bound_by = bound(4.0 * rows * C * Hd, nbytes, BF16_PEAK)
        o = dict(blocks=[[b.h0, b.w0, *b.local] for b in blocks], same_drops=True,
                 bit_for_bit=bitwise, max_rel_err_vs_plain=worst,
                 ms_whole=timed_ms(lambda: kernel[k](x), 10),
                 ms=timed_ms(lambda: kernel[k](xq, quarter), 10),
                 ms_unmapped=timed_ms(lambda: kernel[k](xq), 10),
                 ms_h2=timed_ms(lambda: kernel[k](xh, half), 10),
                 plain_ms=timed_ms(lambda: plain[k](xq, quarter), 3),
                 library_ms=timed_ms(lambda: library[k](xq), 10),
                 bound_ms=bound_ms, bound_by=bound_by)
        log(f"{k} bf16 batch 2, dropout 0.1, on the blocks {o['blocks']} of {H} x {W}: the whole "
            f"grid's dropped elements at every origin, bit for bit {bitwise}; max rel err against "
            f"the plain version at the origin {worst:.3e} (tolerance 1e-2); a {hb} x {wb} block "
            f"at ({hb}, {wb}) {o['ms']} ms (the same rows without the row map "
            f"{o['ms_unmapped']} ms; plain {o['plain_ms']} ms; bf16 chain without dropout "
            f"{o['library_ms']} ms; bound {bound_ms:.4f} ms, {bound_by}), a {hb} x {W} block at "
            f"({hb}, 0) {o['ms_h2']} ms, the whole grid {o['ms_whole']} ms, on {smi_line}")
        report[k]["origin"] = o
        rep[f"{k}_origin"] = o
        del whole, xq, xh
    del x, a, c, w1, b1, w2, b2, w1b, w2b, b1b, b2b

    # (d) K4 on the channel shards of "w" and on the "h" = 2 route
    fast_cfg = main_path.sfno_configs(C, SPATIAL_LAYERS, "bfloat16", SPATIAL_SHAPE,
                                      thresh=main_path.FAST_WINDOW["thresh"])[1]
    L4, M4 = fast_cfg.modes
    R = int(main_path.FAST_WINDOW["rank"] * C)
    k4 = {}
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-5)):
        kw = dict(grid="legendre-gauss", matmul_dtype=dtype, kernel_layout=True)
        fwd = RealSHT(H, W, L4, M4, **kw).to(dev)
        inv = InverseRealSHT(H, W, L4, M4, **kw).to(dev)
        A, S = fwd.analysis_mhl, inv.synthesis_mhl
        l_first = torch.minimum(fwd.analysis_l_first, inv.synthesis_l_first)
        C4 = torch.randn((L4, R, 2), generator=g, device=dev) * 0.5
        xf = torch.randn((1, H, M4, 2 * R, 2), generator=g, device=dev).to(dtype)
        hb = H // 2
        cases = {"whole": (xf, S, C4)}
        for nw in (2, 4):
            cases[f"w{nw}"] = (xf[..., :2 * R // nw, :].contiguous(), S,
                               C4[:, :R // nw].contiguous())
        for h0 in (0, hb):
            cases[f"h2_rows{h0}"] = (xf, S[:, h0:h0 + hb].contiguous(), C4)
        for name, (xx, SS, CC) in cases.items():
            ops = (xx, A, SS, CC, l_first)
            y = fused_rank(*ops)
            sync()
            want = fused_rank_plain(*ops[:4])
            abs_err, rel_err = rel(y, want)
            check(tuple(y.shape) == (1, SS.shape[1], M4) + tuple(xx.shape[3:]),
                  f"K4 {name} {dtype}: output {tuple(y.shape)}")
            check(rel_err <= tol, f"K4 {name} {dtype} disagrees with its plain version "
                                  f"({rel_err:.3e} > {tol:g})")
            o = dict(max_abs_err=abs_err, max_rel_err=rel_err, tolerance=tol,
                     xf=list(xx.shape), S_rows=SS.shape[1])
            if dtype == torch.bfloat16:
                bound_ms, bound_by = k4_bound(*ops)
                o.update(ms=timed_ms(lambda: fused_rank(*ops), 20),
                         device_ms=timed_ms(lambda: fused_rank(*ops), 20, spin=True),
                         plain_ms=timed_ms(lambda: fused_rank_plain(*ops[:4]), 5),
                         library_ms=timed_ms(lambda: k4_library(*ops[:4]), 20),
                         bound_ms=bound_ms, bound_by=bound_by)
                log(f"K4 {name} bf16, xf {o['xf']}, {o['S_rows']} synthesis rows: max rel err "
                    f"{rel_err:.3e} (tolerance {tol:g}); kernel {o['ms']} ms (on the device, "
                    f"queued behind a spin, {o['device_ms']} ms), plain "
                    f"{o['plain_ms']} ms, bf16 torch.bmm chain {o['library_ms']} ms, bound "
                    f"{bound_ms:.4f} ms ({bound_by}) on {smi_line}")
            else:
                log(f"K4 {name} float32, xf {o['xf']}, {o['S_rows']} synthesis rows: max rel "
                    f"err {rel_err:.3e} (tolerance {tol:g})")
            k4[f"{name}_{'bf16' if dtype == torch.bfloat16 else 'f32'}"] = o
            del y, want
        del fwd, inv, A, S, xf, C4, cases
    report["K4"]["shard"] = k4
    rep["K4"] = k4

    # (c), (e), (f): the spatial route over an NCCL group of one
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = {"SPHDY_COORDINATOR": f"127.0.0.1:{port}", "SPHDY_NUM_PROCESSES": "1",
           "SPHDY_PROCESS_ID": "0"}
    maybe_init_multihost(env=env, backend="nccl" if cuda else "gloo")
    names = ("all_reduce", "all_to_all_single", "reduce_scatter_tensor",
             "all_gather_into_tensor")
    real = {n: getattr(dist, n) for n in names}
    calls = dict.fromkeys(names, 0)

    def counting(n):
        def call(*args, **kwargs):
            calls[n] += 1
            return real[n](*args, **kwargs)
        return call

    def zero_counts():
        for f in (*wrappers.values(), weight_image, dhconv_weight_image):
            f.launches = 0

    def counted(fn):
        """``fn()`` with the kernels' launches and the collectives counted
        (from 0), and its seconds."""
        zero_counts()
        for n in names:
            calls[n] = 0
            setattr(dist, n, counting(n))
        try:
            t0 = time.perf_counter()
            out = fn()
            seconds = time.perf_counter() - t0
        finally:
            for n in names:
                setattr(dist, n, real[n])
        launches = {k: f.launches for k, f in wrappers.items()}
        launches["K1 images"] = dhconv_weight_image.launches
        zero_counts()
        return out, seconds, launches, dict(calls)

    try:
        mesh = make_mesh(data=1, h=1, w=1)
        check(all(grp is dist.group.WORLD for grp in mesh.groups.values()),
              "a world of one: every mesh axis should run its collectives on the world group")
        inp = main_path.window_inputs(N_STEPS, SPATIAL_SHAPE, device=device)
        size = dict(embed=SPATIAL_EMBED, layers=SPATIAL_LAYERS, img_shape=SPATIAL_SHAPE,
                    device=device, seed=0)

        def route_window(what, path, f32_path, per_forward, needs, phase_key):
            """One 12-step window of ``path`` at full width, bf16, dropout live,
            with ``make_mesh(1, 1, 1)`` attached to both SFNOs against the same
            stepper's window without it (the same weights and seed: the same
            masks), within BF16_TAIL_VS_PLAIN of the route's own bf16 error
            (the float32 window of ``f32_path`` from the same weights); the
            kernels launched ``per_forward`` a forward both ways, the
            collectives ``needs`` made."""
            st = main_path.build(dtype="bfloat16", **size, **path)
            nets = (st.exp.model, st.exp.interpolator.model)
            forwards = []
            hooks = [net.register_forward_pre_hook(lambda mod, args: forwards.append(1))
                     for net in nets]

            def window(stepper, seed):
                out = stepper.run_window(inp["x0"], inp["forcing"], inp["sst"], inp["mask"],
                                         torch.Generator().manual_seed(seed), N_STEPS)
                sync()
                return out

            window(st, 1)  # warm-up: K1's images, cuBLAS, the allocator
            forwards.clear()
            (_, one), one_s, one_launches, _ = counted(lambda: window(st, 2))
            n_fwd = len(forwards)
            for net in nets:
                net.set_mesh(mesh)
            try:
                window(st, 1)  # the spatial route's warm-up
                forwards.clear()
                (_, sp), sp_s, launches, coll = counted(lambda: window(st, 2))
                sp_fwd = len(forwards)
            finally:
                for net in nets:
                    net.set_mesh(None)
            for hk in hooks:
                hk.remove()
            st32 = main_path.build(dtype="float32", **size, **f32_path)
            st32.exp.model.load_state_dict(st.exp.model.state_dict())
            st32.exp.interpolator.model.load_state_dict(st.exp.interpolator.model.state_dict())
            _, p32 = window(st32, 2)
            del st32
            other = [ch for ch in range(sp.shape[-1]) if ch != 1]  # the model-driven channels
            scale = float(p32[..., other].abs().max())
            gap = float((sp - one).abs().max())
            noise = float((one - p32).abs().max())
            phase_s = runs.get(phase_key, {}).get("seconds")
            o = dict(seconds=sp_s, one_process_seconds=one_s, phase_seconds=phase_s,
                     launches=launches, one_process_launches=one_launches, forwards=sp_fwd,
                     collectives=coll, gap=gap, bit_for_bit=bool(torch.equal(sp, one)),
                     bf16_noise=noise, scale=scale, ratio=gap / noise if noise else None)
            log(f"{what} on the spatial route over an NCCL group of one, {SPATIAL_EMBED} x "
                f"{SPATIAL_LAYERS} on {SPATIAL_SHAPE}, bf16, dropout live: {N_STEPS} steps in "
                f"{sp_s:.3f} s against {one_s:.3f} s without the mesh in this phase and "
                f"{phase_key}'s {phase_s} s; launches {launches} over {sp_fwd} SFNO forwards "
                f"(without the mesh {one_launches}, {n_fwd} forwards); collectives {coll}; max "
                f"|spatial - one process| {gap:.3e} = {gap / scale:.3e} of the largest "
                f"model-driven prediction (bit for bit: {o['bit_for_bit']}), the route's own "
                f"bf16 error max |bf16 - float32| {noise:.3e}; ratio {o['ratio']} (tolerance "
                f"{BF16_TAIL_VS_PLAIN:g}); on {smi_line}")
            check(bool(torch.isfinite(sp).all()) and tuple(sp.shape) == tuple(one.shape),
                  f"{what}: the spatial window is non-finite or shaped {tuple(sp.shape)}")
            check(gap <= BF16_TAIL_VS_PLAIN * noise,
                  f"{what}: the spatial route's window disagrees with the window without "
                  f"the mesh")
            check(all(coll[n] > 0 for n in needs),
                  f"{what}: the spatial window made the collectives {coll}: the route was "
                  f"not taken")
            want = {k: n * sp_fwd for k, n in per_forward.items()}
            check(sp_fwd == n_fwd and all(launches[k] == one_launches[k] == n
                                          for k, n in want.items())
                  and launches["K1 images"] == 0,
                  f"{what}: the spatial window launched {launches} over {sp_fwd} forwards; "
                  f"without the mesh {one_launches} over {n_fwd}; expected {want} and no image")
            del st, one, sp, p32
            return o

        # (c) phase 7's fused-tail window
        tail = dict(use_pallas=True, fused_tail=True, peel=True, scan_layers=True)
        runs["spatial"] = rep["window"] = route_window(
            "the fused-tail window", tail, tail,
            {"K1": SPATIAL_LAYERS, "K2": 0, "K3": SPATIAL_LAYERS, "K4": 0},
            ("all_to_all_single", "all_reduce", "reduce_scatter_tensor"), "fused_tail")
        # (e) phase 8's fast window: K4 on the "w" shard (the "h" gather of
        # one rank is no call)
        fast = dict(main_path.FAST_WINDOW)
        runs["spatial_fast"] = rep["fast_window"] = route_window(
            "the fast window", fast, dict(fast, spectral_io=""),
            {"K1": 0, "K2": 0, "K3": 0, "K4": SPATIAL_LAYERS - 2},
            ("all_to_all_single", "all_reduce"), "fast")
        # (g) phase 13's folded window: the folded analysis's partial sums
        # all-reduced over "h" (its mirror exchange is no call where "h" is 1)
        fold = dict(tail, sht_fold_symmetry=True)
        runs["spatial_fold"] = rep["fold_window"] = route_window(
            "the folded window", fold, fold,
            {"K1": SPATIAL_LAYERS, "K2": 0, "K3": SPATIAL_LAYERS, "K4": 0},
            ("all_to_all_single", "all_reduce", "reduce_scatter_tensor"), "fold")

        # (f) one float32 forward of each routed option on the route
        base = main_path.sfno_configs(C, SPATIAL_LAYERS, "float32", SPATIAL_SHAPE,
                                      use_pallas=False, fused_mlp=False)[1]
        x = torch.randn((1, H, W, base.out_chans), device=dev, generator=g)
        forcing = torch.randn((1, H, W, base.in_chans - base.out_chans), device=dev,
                              generator=g)
        t = torch.ones(1, device=dev)
        pipe = dict(rank=0.25, hard_thresholding_fraction=main_path.FAST_WINDOW["thresh"])
        scatter, reduced, trade = "reduce_scatter_tensor", "all_reduce", "all_to_all_single"
        cases = {
            "dense dhconv, XLA form": ({}, scatter),
            "merged dhconv": (dict(merged_dhconv=True), scatter),
            "separable dhconv": (dict(separable=True), trade),
            f"diagonal filter at embed {OPT_DIAG_EMBED}": (
                dict(operator_type="diagonal", embed_dim=OPT_DIAG_EMBED), scatter),
            f"separable diagonal filter at embed {OPT_DIAG_EMBED}": (
                dict(operator_type="diagonal", separable=True, embed_dim=OPT_DIAG_EMBED), trade),
            "CP rank 0.25 in spectral space": (
                dict(factorization="cp", rank=0.25, rank_pipeline=False), reduced),
            "Tucker rank 0.25 in spectral space": (
                dict(factorization="tucker", rank=0.25, rank_pipeline=False), reduced),
            "TT rank 0.25": (dict(factorization="tt", rank=0.25), reduced),
            "CP rank pipeline": (dict(factorization="cp", **pipe), reduced),
            "CP rank pipeline, K4 (float32)": (dict(factorization="cp", fused_rank=True, **pipe),
                                               trade),
            "Tucker rank pipeline": (dict(factorization="tucker", **pipe), scatter),
            "non-linear filter, shared": (dict(filter_type="non-linear"), trade),
            "non-linear filter, per degree": (
                dict(filter_type="non-linear", operator_type="l-dependant"), trade),
            "scale_factor 2": (dict(scale_factor=2), scatter),
            "folded Legendre stage, K1": (dict(sht_fold_symmetry=True, use_pallas=True),
                                          scatter),
            "planar FFT transform, K1": (dict(spectral_transform="fft", use_pallas=True),
                                         scatter),
        }
        forwards = {}
        for name, (kw, need) in cases.items():
            kw = dict(kw)
            fused = kw.pop("fused_rank", False)
            net = SFNO(dataclasses.replace(base, **kw), fused_rank=fused).to(dev)
            net.init_weights(torch.Generator(device=dev).manual_seed(0))
            with torch.no_grad():
                want = net(x, time=t, static_condition=forcing)
                net.set_mesh(mesh)
                try:
                    sync()
                    got, seconds, launches, coll = counted(
                        lambda: (net(x, time=t, static_condition=forcing), sync())[0])
                finally:
                    net.set_mesh(None)
            abs_err, rel_err = rel(got, want)
            k4_want = sum(bool(getattr(b.filter, "fused_rank", False)) for b in net.blocks)
            k1_want = sum(getattr(b.filter, "_k1_image", None) is not None for b in net.blocks)
            forwards[name] = dict(ms=seconds * 1e3, max_abs_err=abs_err, max_rel_err=rel_err,
                                  launches=launches, collectives=coll)
            log(f"option on the spatial route, {name}: float32 forward {seconds * 1e3:.2f} ms "
                f"(the route's first), max rel err against the forward without the mesh "
                f"{rel_err:.3e} (tolerance 1e-4), K1 launches {launches['K1']}, K4 launches "
                f"{launches['K4']}, collectives {coll}")
            check(bool(torch.isfinite(got).all()) and rel_err <= 1e-4,
                  f"option {name}: the spatial route disagrees with the forward without the "
                  f"mesh ({rel_err:.3e})")
            check(coll[need] > 0 and coll[trade] > 0,
                  f"option {name}: the collectives {coll}, expected {need}: the route was not "
                  f"taken")
            check(launches["K4"] == k4_want, f"option {name}: K4 launched {launches['K4']} "
                                             f"times, expected {k4_want}")
            check(launches["K1"] == k1_want, f"option {name}: K1 launched {launches['K1']} "
                                             f"times, expected {k1_want}")
            del net, want, got
            if cuda:
                torch.cuda.empty_cache()
        rep["options"] = forwards
        # the bytes each new route moves over "h" per forward at this width
        # and grid (batch 1, every block), from the shapes: the folded
        # stage's mirror exchange (the rows a rank sends, in the matmul
        # dtype) beside the all-reduce buffer of its partial sums, and the
        # FFT's "h" gather (the rows a rank receives, float32)
        M = W // 2 + 1
        route_bytes = {}
        for nh, nw in ((2, 1), (2, 2), (4, 1)):
            sent = max(mirror_pairs(H, nh, i)[1] for i in range(nh))
            per_row = M * (C // nw) * 2 * SPATIAL_LAYERS
            route_bytes[f"h{nh}w{nw}"] = dict(
                fold_exchange_bf16=sent * per_row * 2, fold_exchange_f32=sent * per_row * 4,
                fold_all_reduce_buffer=L * per_row * 4,
                fft_gather=(H - H // nh) * per_row * 4)
        log(f"bytes over 'h' per forward at {C} x {SPATIAL_LAYERS} on {SPATIAL_SHAPE}, batch 1, "
            f"by (h, w): {route_bytes}")
        rep["route_bytes"] = route_bytes
        del inp, x, forcing
        if cuda:
            torch.cuda.empty_cache()

        # (h) the published UNet on the route
        runs["spatial_unet"] = rep["unet"] = phase21_unet(smi_line, report, mesh, counted,
                                                          device)
    finally:
        dist.destroy_process_group()
    check(not dist.is_initialized(), "the process group outlived phase 21")
    if cuda:
        torch.cuda.empty_cache()
    report["spatial"] = rep


def phase21_unet(smi_line, report, mesh, counted, device="cuda") -> dict:
    """Phase 21 (h): phase 16's published UNet (UNET_DIM, UNET_MULTS,
    UNET_SHAPE -> UNET_UPSAMPLE, UNET_STATE channels, float32, batch 1, the
    interpolator's dropout live) with ``mesh`` (``make_mesh(1, 1, 1)`` over
    the NCCL group of one) attached to both UNets: every level but the
    bottleneck's on the route (halo exchanges that make no call where "h"
    and "w" are 1, grid-wide GroupNorm and attention sums, the outer
    resampler's whole-grid weights), the bottleneck whole. With cuDNN's TF32
    off, one interpolator forward within 1e-5 and the 12-step window within
    1e-4 of the largest value without the mesh (the same seeds: the same
    masks); with TF32 on, as a user runs it, the window's seconds both ways
    beside phase 16's and with its one-rank all-reduces skipped (identities
    on a group of one), its collectives by kind, and K1-K4 launched no time.
    Then the bytes over "h" and "w" a forward at h = 2, w = 2 and at h = 4,
    by level: one interpolator forward on each rank's block of a layout
    whose collectives are recorded, not made (``counted``: phase 21's
    counter of launches and collectives)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from spherical_dyffusion_tpu_torch import main_path
    from spherical_dyffusion_tpu_torch.models.unet import level_plan
    from spherical_dyffusion_tpu_torch.parallel.mesh import Mesh

    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    st = main_path.build_unet(img_shape=UNET_SHAPE, n_state=UNET_STATE, dim=UNET_DIM,
                              dim_mults=UNET_MULTS, upsample_dims=UNET_UPSAMPLE, device=device)
    nets = (st.exp.model, st.exp.interpolator.model)
    inp = main_path.window_inputs(N_STEPS, UNET_SHAPE, UNET_STATE, device=device)

    def window(seed):
        out = st.run_window(inp["x0"], inp["forcing"], inp["sst"], inp["mask"],
                            torch.Generator().manual_seed(seed), N_STEPS)
        sync()
        return out

    def attach(m):
        for net in nets:
            net.set_mesh(m)

    def gap(got, want):
        return float((got - want).abs().max() / want.abs().max())

    rep = {}
    tf32 = torch.backends.cudnn.allow_tf32
    try:
        # agreement with TF32 off: the route's blocks are padded tensors of
        # other shapes, for which cuDNN may pick other algorithms
        torch.backends.cudnn.allow_tf32 = False
        net = st.exp.interpolator.model
        g = torch.Generator(device=dev).manual_seed(22)
        x = torch.randn((1,) + tuple(UNET_SHAPE) + (net.cfg.in_chans,), generator=g, device=dev)
        t = torch.full((1,), 3.0, device=dev)
        with torch.no_grad():
            want = net(x, time=t, deterministic=False, generator=torch.Generator().manual_seed(3))
            net.set_mesh(mesh)
            try:
                got = net(x, time=t, deterministic=False,
                          generator=torch.Generator().manual_seed(3))
            finally:
                net.set_mesh(None)
        rep["forward_gap"] = gap(got, want)
        _, one = window(2)
        attach(mesh)
        try:
            plan = nets[0].plan
            _, sp = window(2)
        finally:
            attach(None)
        rep["window_gap"] = gap(sp, one)
        rep["split_levels"] = plan.split
        log(f"UNet on the spatial route over an NCCL group of one ({UNET_DIM} x "
            f"{list(UNET_MULTS)}, {UNET_SHAPE} -> {UNET_UPSAMPLE}, levels 0-{plan.split - 1} "
            f"on the route, {plan.grids[plan.split]} whole), cuDNN TF32 off: interpolator "
            f"forward with dropout live max gap {rep['forward_gap']:.3e} of its largest output "
            f"(tolerance 1e-5), {N_STEPS}-step window {rep['window_gap']:.3e} of its largest "
            f"prediction (tolerance 1e-4)")
        check(bool(torch.isfinite(sp).all()) and sp.shape == one.shape,
              f"UNet route window: shape {tuple(sp.shape)} or non-finite")
        check(rep["forward_gap"] <= 1e-5, "the UNet's forward on the route disagrees with the "
                                          "forward without the mesh")
        check(rep["window_gap"] <= 1e-4, "the UNet's window on the route disagrees with the "
                                         "window without the mesh")
        del x, got, want, one, sp

        # the window's seconds with TF32 on, both ways, in this phase
        torch.backends.cudnn.allow_tf32 = True
        window(1)
        _, one_s, one_launches, _ = counted(lambda: window(2))
        attach(mesh)
        real_all_reduce = dist.all_reduce
        try:
            window(1)  # the route's warm-up: cuDNN's plans for the block shapes
            _, sp_s, launches, coll = counted(lambda: window(2))
            # the same window with its all-reduces skipped, which on a group
            # of one leave every tensor as it is: the route's cost without
            # NCCL's host work
            dist.all_reduce = lambda *args, **kwargs: None
            t0 = time.perf_counter()
            window(2)
            quiet_s = time.perf_counter() - t0
        finally:
            dist.all_reduce = real_all_reduce
            attach(None)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    phase16_s = report.get("unet", {}).get("window", {}).get("seconds")
    rep.update(seconds=sp_s, one_process_seconds=one_s, phase16_seconds=phase16_s,
               seconds_without_all_reduce=quiet_s, launches=launches,
               one_process_launches=one_launches, collectives=coll)
    log(f"UNet window on the route, TF32 on: {N_STEPS} steps in {sp_s:.3f} s against {one_s:.3f} "
        f"s without the mesh in this phase and phase 16's {phase16_s} s; {quiet_s:.3f} s on the "
        f"route with its one-rank all-reduces skipped; collectives {coll}; launches {launches} "
        f"(without the mesh {one_launches}); on {smi_line}")
    check(not any(v for v in launches.values()) and not any(v for v in one_launches.values()),
          f"the UNet route launched a port kernel: {launches}")
    check(coll["all_reduce"] > 0 and coll["all_gather_into_tensor"] == 0,
          f"the UNet window made the collectives {coll}: the route was not taken")

    # the bytes over "h" and "w" a forward, by level: every rank's block of
    # a (1, h, w, 1) layout, its collectives recorded and not made
    net = st.exp.interpolator.model
    n = len(net.resamples_down)
    where = ["init_conv"]

    def level(name):
        m = re.match(r"(down|up)(\d+)_", name)
        if m:
            return int(m[2]) if m[1] == "down" else n - 1 - int(m[2])
        return n - 1 if name.startswith("mid_") else 0

    def nbytes(t):
        return t.numel() * t.element_size()

    sizes = {"all_to_all_single": lambda out, sent: nbytes(sent),  # sent
             "all_gather_into_tensor": lambda out, part: nbytes(out) - nbytes(part),  # received
             "all_reduce": lambda buf: nbytes(buf)}  # the reduced buffer
    kinds = {"all_to_all_single": "halo", "all_gather_into_tensor": "gather",
             "all_reduce": "sums"}
    route_bytes, real = {}, {k: getattr(dist, k) for k in sizes}
    hooks = [net.get_submodule(name).register_forward_pre_hook(
        lambda mod, args, name=name: where.__setitem__(0, name))
        for name, _ in net.named_children()
        if re.match(r"(down|up)\d+_|mid_|init_conv|final_", name)]
    try:
        for nh, nw in ((2, 2), (4, 1)):
            tally = {}

            def record(kind):
                def call(*args, group=None, **kw):
                    key = f"level {level(where[0])} {kinds[kind]} over {group}"
                    tally[key] = tally.get(key, 0) + sizes[kind](*args[:2 if kind != "all_reduce"
                                                                         else 1])
                return call

            for k in sizes:
                setattr(dist, k, record(k))
            try:
                for r in range(nh * nw):
                    lay = Mesh(ranks=np.arange(nh * nw).reshape(1, nh, nw, 1),
                               groups={"data": None, "h": "h", "w": "w" if nw > 1 else None,
                                       "matmul": None}, rank=r)
                    net.set_mesh(lay)
                    where[0] = "init_conv"
                    with torch.no_grad():
                        net(torch.zeros((1, UNET_SHAPE[0] // nh, UNET_SHAPE[1] // nw,
                                         net.cfg.in_chans), device=dev),
                            time=torch.ones(1, device=dev))
                    sync()
            finally:
                net.set_mesh(None)
                for k in sizes:
                    setattr(dist, k, real[k])
            route_bytes[f"h{nh}w{nw}"] = dict(sorted(tally.items()),
                                              split_levels=level_plan(net.cfg, nh, nw).split)
            log(f"UNet interpolator bytes a forward over every rank at h = {nh}, w = {nw}, batch "
                f"1, float32 (halo: sent; gather: received; sums: the reduced buffers): "
                f"{route_bytes[f'h{nh}w{nw}']}")
    finally:
        for hk in hooks:
            hk.remove()
    rep["route_bytes"] = route_bytes
    del st, nets, net, inp
    if cuda:
        torch.cuda.empty_cache()
    return rep


def phase18(smi_line, wrappers, report, runs, device="cuda") -> None:
    """Phase 18: the netCDF data layer at DATA_EMBED x DATA_LAYERS on
    DATA_SHAPE, in a temporary directory: a dataset written by
    ``data/hdf5.py:write_hdf5`` (no h5py on this machine) with the FV3GFS
    datamodule config's names; (a) ``NetCDFTimeSeries`` windows against the
    written arrays; (c) the train command line with ``datamodule.kind:
    fv3gfs`` (run before (b), whose forecaster loads its interpolator);
    (b) ``run_inference`` over ``validation_loader.dataset.data_path`` on
    the fused-tail path against the same rollout over an in-memory source
    of the same arrays; (d) ``run_dataset_inference`` on a predictions file
    against the aggregator on the same arrays."""
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from spherical_dyffusion_tpu_torch import interface
    from spherical_dyffusion_tpu_torch.data.coords import HorizontalCoordinates, SigmaCoordinates
    from spherical_dyffusion_tpu_torch.data.datasets import NetCDFTimeSeries, TimeSeriesSource
    from spherical_dyffusion_tpu_torch.data.hdf5 import write_hdf5
    from spherical_dyffusion_tpu_torch.data.netcdf import read_scalar_dataset
    from spherical_dyffusion_tpu_torch.evaluation.aggregators import InferenceAggregator
    from spherical_dyffusion_tpu_torch.inference.loop import (
        InferenceConfig,
        run_dataset_inference,
        run_inference,
    )
    from spherical_dyffusion_tpu_torch.inference.stepper import DYffusionStepper
    from spherical_dyffusion_tpu_torch.ops.pallas_contractions import dhconv
    from spherical_dyffusion_tpu_torch.run_inference import main_from_config
    from spherical_dyffusion_tpu_torch.train import run_model
    from spherical_dyffusion_tpu_torch.training.trainer import Trainer
    from spherical_dyffusion_tpu_torch.utils.config import CONFIG_DIR

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    rep = {}
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_data_")
    d = Path(tmp.name)
    dm_json = json.loads(Path(CONFIG_DIR, "datamodule", "fv3gfs.json").read_text())
    state, forcings = list(dm_json["in_names"]), list(dm_json["forcing_names"])
    mask = dm_json["prescriber"]["mask_name"]
    fields = state + forcings + [mask]
    H, W = DATA_SHAPE
    lat = (90.0 - (np.arange(H) + 0.5) * (180.0 / H)).astype(np.float64)
    lon = ((np.arange(W) + 0.5) * (360.0 / W)).astype(np.float64)
    ak, bk = np.linspace(0.0, 2e4, 9), np.linspace(0.0, 1.0, 9)

    def zero_counts():
        for fn in wrappers.values():
            fn.launches = 0

    # the dataset: float32 fields from a numpy seed; each file's arrays kept
    rng = np.random.default_rng(18)
    written, nbytes = {}, 0
    t0 = time.perf_counter()
    for member, steps in (("ic_0001", (8, 8)), ("validation/ic_0011", (13, 12))):
        os.makedirs(d / "data" / member)
        for i, n in enumerate(steps):
            arrays = {v: rng.standard_normal((n, H, W), dtype=np.float32) for v in fields}
            arrays[mask] = (arrays[mask] > 0).astype(np.float32)
            path = d / "data" / member / f"part_{i}.nc"
            write_hdf5(str(path), {**arrays, "lat": lat, "lon": lon,
                                   **{f"ak_{k}": np.float64(a) for k, a in enumerate(ak)},
                                   **{f"bk_{k}": np.float64(b) for k, b in enumerate(bk)}},
                       {"/": {"title": "chip_smoke phase 18"}})
            written[(member, i)] = arrays
            nbytes += path.stat().st_size
    train_all = {v: np.concatenate([written[("ic_0001", i)][v] for i in (0, 1)])
                 for v in state + forcings}
    os.makedirs(d / "stats")
    write_hdf5(str(d / "stats" / "centering.nc"),
               {v: np.float32(a.mean()) for v, a in train_all.items()})
    write_hdf5(str(d / "stats" / "scaling.nc"),
               {v: np.float32(a.std()) for v, a in train_all.items()})
    write_s = time.perf_counter() - t0
    del train_all
    per_step = len(fields) * H * W * 4
    log(f"dataset: {len(fields)} fields of {H} x {W} float32 ({per_step / 1e6:.2f} MB a step), "
        f"data/ic_0001 in files of 8 and 8 steps, data/validation/ic_0011 in 13 and 12, "
        f"stats/centering.nc and scaling.nc: {nbytes / 1e6:.1f} MB written in {write_s:.2f} s "
        f"by write_hdf5")
    rep["dataset"] = dict(fields=len(fields), bytes=nbytes, write_s=write_s,
                          step_bytes=per_step)

    # (a) windows of the validation member against the written arrays
    val_dir = str(d / "data" / "validation" / "ic_0011")
    val = {v: np.concatenate([written[("validation/ic_0011", i)][v] for i in (0, 1)])
           for v in fields}
    src = NetCDFTimeSeries(val_dir)
    check(src.n_timesteps == 25 and tuple(src.spatial_shape) == (H, W),
          f"NetCDFTimeSeries: {src.n_timesteps} steps of {src.spatial_shape}")
    for start, length in ((0, 13), (6, 12), (12, 13)):
        got = src.read_window(start, length, fields)
        bad = [v for v in fields if not np.array_equal(got[v], val[v][start:start + length])]
        check(not bad, f"NetCDFTimeSeries window ({start}, {length}) differs in {bad[:4]}")
    t0 = time.perf_counter()
    got = src.read_window(6, N_STEPS, fields)
    read_s = time.perf_counter() - t0
    read_bytes = sum(a.nbytes for a in got.values())
    check(np.array_equal(src.horizontal.lat, lat) and np.array_equal(src.sigma.bk, bk),
          "NetCDFTimeSeries: horizontal or sigma differ from the files")
    log(f"(a) NetCDFTimeSeries windows equal the written arrays bit for bit (three windows, "
        f"one across the file boundary); a {N_STEPS}-step window of {len(fields)} fields: "
        f"{read_bytes / 1e6:.1f} MB in {read_s:.3f} s = {read_bytes / 1e6 / read_s:.0f} MB/s "
        f"(page cache warm: the files were just written); on {smi_line}")
    rep["read"] = dict(bytes=read_bytes, seconds=read_s, mb_per_s=read_bytes / 1e6 / read_s)
    del got

    # (c) the train command line with datamodule.kind fv3gfs: 2 interpolator
    # steps, float32, K1 on; each step's K1 launches and those of its dx
    def run_config(experiment, **extra):
        cfg = {"experiment": experiment, "name": f"data-{experiment}", "seed": 0,
               "platform": device, "ckpt_dir": str(d / "ckpt"), "log_dir": str(d / "logs"),
               "verbose": False,
               "datamodule": dict(dm_json, out_names=state, data_dir=str(d / "data"),
                                  data_dir_stats=str(d / "stats"), prediction_horizon=6,
                                  prediction_horizon_long=6, max_val_samples=1,
                                  max_train_samples=2),
               "model": {"kind": "sfno", "embed_dim": DATA_EMBED, "num_layers": DATA_LAYERS,
                         "use_pallas": True, "dropout_mlp": 0.1},
               "module": {"enable_inference_dropout": True, "num_predictions": 2},
               "diffusion": {"forward_conditioning": "none"},
               "trainer": {"epochs": 1, "warmup_steps": 1, "lr": 4e-4, "use_ema": False}}
        for k, v in extra.items():
            cfg[k] = {**cfg.get(k, {}), **v}
        path = d / f"{experiment}.json"
        path.write_text(json.dumps(cfg))
        return str(path), cfg

    steps = []
    real_step, real_grad = Trainer.train_step, torch.autograd.grad
    backward = [0]

    def timed_step(self, *a, **k):
        sync()
        n0, b0, t0 = dhconv.launches, backward[0], time.perf_counter()
        out = real_step(self, *a, **k)
        sync()
        steps.append(dict(ms=(time.perf_counter() - t0) * 1e3, k1=dhconv.launches - n0,
                          k1_backward=backward[0] - b0))
        return out

    def counted_grad(*a, **k):
        n0 = dhconv.launches
        out = real_grad(*a, **k)
        backward[0] += dhconv.launches - n0
        return out

    ip_path, _ = run_config("interpolation")
    Trainer.train_step, torch.autograd.grad = timed_step, counted_grad
    try:
        t0 = time.perf_counter()
        ip = run_model(ip_path, [])
        train_s = time.perf_counter() - t0
    finally:
        Trainer.train_step, torch.autograd.grad = real_step, real_grad
    losses = ip["history"]["step_losses"]
    check(len(losses) == 2 and all(np.isfinite(losses)), f"fv3gfs training losses {losses}")
    check([(s["k1"], s["k1_backward"]) for s in steps] == [(2 * DATA_LAYERS, DATA_LAYERS)] * 2,
          f"fv3gfs training: K1 launches a step {[(s['k1'], s['k1_backward']) for s in steps]},"
          f" expected ({2 * DATA_LAYERS}, {DATA_LAYERS}) (forward and dx) as in phase 11")
    means = read_scalar_dataset(str(d / "stats" / "centering.nc"))
    stds = read_scalar_dataset(str(d / "stats" / "scaling.nc"))
    norm = ip["trainer"].exp.normalizer
    check(norm.names == tuple(state)
          and norm.means.cpu().tolist() == [float(np.float32(means[v])) for v in state]
          and norm.stds.cpu().tolist() == [float(np.float32(stds[v])) for v in state],
          "fv3gfs training: the normalizer differs from the stats files")
    log(f"(c) train command line, datamodule.kind fv3gfs, interpolator at {DATA_EMBED} x "
        f"{DATA_LAYERS}, float32, K1 on: 2 steps, losses {[round(v, 5) for v in losses]}, "
        f"step ms {[round(s['ms'], 2) for s in steps]} (synchronized; phase 11's median "
        f"{report.get('training', {}).get('interpolator', {}).get('step_ms', float('nan')):.2f}"
        f" ms on synthetic data), K1 launches a step {[s['k1'] for s in steps]} (dx "
        f"{[s['k1_backward'] for s in steps]}); the normalizer equals the stats files; "
        f"{train_s:.2f} s with building, validation and the checkpoint")
    rep["train"] = dict(losses=losses, step_ms=[s["ms"] for s in steps],
                        k1=[s["k1"] for s in steps], k1_backward=[s["k1_backward"] for s in steps],
                        seconds=train_s)
    runs["data_train"] = dict(launches={"K1": sum(s["k1"] for s in steps), "K2": 0, "K3": 0,
                                        "K4": 0})
    del ip
    torch.cuda.empty_cache()

    # (b) the forecaster's checkpoint (seeded weights over the fv3gfs
    # datamodule, its interpolator (c)'s), then run_inference over the
    # validation member's files: bf16, the fused-tail path
    fc_path, fc_cfg = run_config("dyffusion", diffusion={
        "interpolator_checkpoint_path": str(d / "ckpt" / "data-interpolation_last.ckpt")})
    dm = interface.get_datamodule(fc_cfg)
    fc = interface.get_experiment(fc_cfg, dm, device=device, seed=1)
    ckpt = str(d / "ckpt" / "data-dyffusion.ckpt")
    torch.save({"params": {k: v.detach().cpu() for k, v in fc.model.state_dict().items()},
                "ema_params": None, "config_json": json.dumps(fc_cfg)}, ckpt)
    del fc, dm
    fused = dict(use_pallas=True, fused_tail=True, scan_layers=True, compute_dtype="bfloat16",
                 sht_matmul_dtype="bfloat16")
    overrides = {"model": fused, "interpolator_model": fused,
                 "diffusion": {"peel_sampler": True}}
    windows = []
    real_window = DYffusionStepper.run_window

    def recorded(self, *a, **k):
        out = real_window(self, *a, **k)
        windows.append(out[1])
        return out

    n_steps = 2 * N_STEPS
    DYffusionStepper.run_window = recorded
    zero_counts()
    try:
        t0 = time.perf_counter()
        out = main_from_config({
            "checkpoint_path": ckpt, "platform": device, "n_forward_steps": n_steps,
            "forward_steps_in_memory": N_STEPS, "experiment_dir": str(d / "inference"),
            "log_zonal_mean_images": False, "verbose": False, "overrides": overrides,
            "validation_loader": {"dataset": {"data_path": val_dir, "n_repeats": 1}}})
        sync()
        wall = time.perf_counter() - t0
    finally:
        DYffusionStepper.run_window = real_window
    launches = {k: fn.launches for k, fn in wrappers.items()}
    runs["data"] = dict(launches=launches)
    summary, stepper = out["summary"], out["stepper"]
    file_preds = torch.cat(windows, dim=1)
    n_windows = len(windows)
    check(isinstance(out["aggregator"], InferenceAggregator) and n_windows == 2,
          f"run_inference over the files: {n_windows} windows")
    for k, n in (("K1", 192 * DATA_LAYERS // 8), ("K3", 192 * DATA_LAYERS // 8), ("K2", 0),
                 ("K4", 0)):
        check(launches[k] == n * n_windows,
              f"run_inference over the files: {k} launched {launches[k]} times in {n_windows} "
              f"windows, expected {n} a {N_STEPS}-step window (phase 7's path)")
    check(bool(torch.isfinite(file_preds).all()), "run_inference over the files: non-finite")

    # the same rollout over an in-memory source of the same arrays
    class MemorySource(TimeSeriesSource):
        def __init__(self, arrays):
            self.arrays = arrays
            self.n_timesteps = next(iter(arrays.values())).shape[0]
            self.spatial_shape = (H, W)

        @property
        def horizontal(self):
            return HorizontalCoordinates(lat, lon)

        @property
        def sigma(self):
            return SigmaCoordinates(ak, bk)

        def read_window(self, start, length, names):
            return {n: self.arrays[n][start:start + length].copy() for n in names}

    mem = MemorySource(val)
    exp = stepper.exp
    out_names = list(exp.out_packer.names)
    agg = InferenceAggregator(out_names, mem.horizontal.area_weights(),
                              log_zonal_mean_images=False,
                              normalizer=exp.normalizer.subset(out_names))
    windows.clear()
    DYffusionStepper.run_window = recorded
    zero_counts()
    try:
        mem_summary = run_inference(stepper, mem, InferenceConfig(
            n_forward_steps=n_steps, forward_steps_in_memory=N_STEPS, n_repeats=1, seed=0),
            aggregator=agg, mask_name=mask, verbose=False)
    finally:
        DYffusionStepper.run_window = real_window
    mem_preds = torch.cat(windows, dim=1)
    same = torch.equal(file_preds, mem_preds)
    gap = float((file_preds.float() - mem_preds.float()).abs().max()
                / mem_preds.float().abs().max())
    mem_logs = agg.get_logs()
    logs_same = mem_logs == out["logs"]
    log(f"(b) run_inference over data_path (the validation member, its second window across "
        f"the file boundary), {n_steps} steps in {N_STEPS}-step windows, {DATA_EMBED} x "
        f"{DATA_LAYERS}, bf16, the fused-tail path (peel, scan_layers, K1 and K3): "
        f"{wall:.2f} s with loading; duration {summary['duration_s']:.3f} s, total "
        f"{summary['total_steps_per_second']:.3f} steps/s, steady (without the first window) "
        f"{summary['steady_steps_per_second']:.3f} steps/s, time/data_loading "
        f"{summary['time/data_loading']:.3f} s; launches {launches}; against the same rollout "
        f"over an in-memory source of the same arrays ({mem_summary['duration_s']:.3f} s, "
        f"time/data_loading {mem_summary['time/data_loading']:.3f} s): predictions "
        f"{'equal bit for bit' if same else f'not bit-equal, max gap {gap:.3e}'}, logs "
        f"{'equal' if logs_same else 'differ'}; on {smi_line}")
    check(same and logs_same, f"run_inference over the files differs from the in-memory "
                              f"source: max gap {gap:.3e} of the largest prediction")
    rep["inference"] = dict(steps=n_steps, wall_s=wall, launches=launches, **{k: summary[k] for k in (
        "duration_s", "total_steps_per_second", "steady_steps_per_second",
        "time/data_loading", "time/run_on_batch")},
        memory_source=dict(duration_s=mem_summary["duration_s"],
                           data_loading_s=mem_summary["time/data_loading"]),
        bit_equal=same)

    # (d) run_dataset_inference on a predictions file, (E, T, H, W) per
    # variable, against the aggregator fed the same arrays
    onorm = exp.normalizer.subset(out_names).to(file_preds.device)
    raw = (file_preds.float() * onorm.stds + onorm.means).cpu().numpy()
    pred_path = str(d / "autoregressive_predictions.nc")
    t0 = time.perf_counter()
    write_hdf5(pred_path, {n: np.ascontiguousarray(raw[..., i]) for i, n in enumerate(out_names)},
               {n: {"long_name": n} for n in out_names})
    pw = time.perf_counter() - t0
    area = src.horizontal.area_weights()
    t0 = time.perf_counter()
    scored = run_dataset_inference(pred_path, src, out_names, area, n_forward_steps=n_steps,
                                   device=device)
    sync()
    score_s = time.perf_counter() - t0
    ref = InferenceAggregator(out_names, area)
    tgt = src.read_window(1, n_steps, out_names)
    ref.record_batch(torch.from_numpy(raw).to(device),
                     torch.from_numpy(np.stack([tgt[n] for n in out_names], -1)).to(device))
    want_logs = ref.get_logs()
    rel = max(abs(scored[k] - v) / max(abs(v), 1.0) for k, v in want_logs.items()) \
        if set(scored) == set(want_logs) else float("inf")
    log(f"(d) run_dataset_inference: a predictions file of {len(out_names)} variables of shape "
        f"{raw.shape[:4]} written in {pw:.2f} s and re-scored in {score_s:.2f} s against the "
        f"validation member: {len(scored)} logs, max gap to the aggregator on the same arrays "
        f"{rel:.3e} (tolerance 1e-6)")
    check(rel <= 1e-6, "run_dataset_inference differs from the aggregator on the same arrays")
    rep["dataset_inference"] = dict(write_s=pw, seconds=score_s, logs=len(scored), max_rel=rel)
    src.close()
    del stepper, exp, out, file_preds, mem_preds, raw, val, written
    tmp.cleanup()
    torch.cuda.empty_cache()
    report["data"] = rep


def phase19(smi_line, wrappers, report, runs, device="cuda") -> None:
    """Phase 19: the rollout's output files at OUT_EMBED x OUT_LAYERS on
    OUT_SHAPE through ``run_inference.main_from_config``, in a temporary
    directory, each file read back through ``data/hdf5.py`` (this machine
    has no h5py) and held against numpy on the host: (a) DYffusion from
    seeded checkpoints on the fused-tail path (K1 and K3 from the run
    config's overrides, bf16, ensemble OUT_ENSEMBLE), two 12-step windows
    with every ``data_writer`` option, ``time_coarsen_factor``
    OUT_COARSEN, a subset of names saved and ``log_video``; (b) ACE from a
    native checkpoint with the prediction file, against the predictions
    that ``run_ace_inference``'s ``on_window`` hands over."""
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from spherical_dyffusion_tpu_torch import interface, main_path
    from spherical_dyffusion_tpu_torch.data import hdf5
    from spherical_dyffusion_tpu_torch.evaluation import plots
    from spherical_dyffusion_tpu_torch.inference import ace_stepper
    from spherical_dyffusion_tpu_torch.inference.stepper import DYffusionStepper
    from spherical_dyffusion_tpu_torch.inference.writers import DynamicHistogram
    from spherical_dyffusion_tpu_torch.run_inference import main_from_config
    from spherical_dyffusion_tpu_torch.utils.naming import long_name

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    dev = torch.device(device)
    rep = {}
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_out_")
    d = Path(tmp.name)
    H, W = OUT_SHAPE
    n_steps, E, f = 2 * N_STEPS, OUT_ENSEMBLE, OUT_COARSEN

    def zero_counts():
        for fn in wrappers.values():
            fn.launches = 0

    def counts():
        return {k: fn.launches for k, fn in wrappers.items()}

    # (a) seeded interpolator and forecaster checkpoints over the debug
    # datamodule at the main path's channels and grid (35 state fields, two
    # forcings), then the inference command line with every writer
    dm_cfg = {"kind": "debug", "channels": 35, "height": H, "width": W, "horizon": 6,
              "n_forcing": 2, "batch_size": 1, "n_timesteps": 8}

    def experiment_cfg(experiment, **diffusion):
        return {"experiment": experiment, "seed": 0, "datamodule": dm_cfg,
                "model": {"kind": "sfno", "embed_dim": OUT_EMBED, "num_layers": OUT_LAYERS,
                          "use_pallas": True, "dropout_mlp": 0.1},
                "module": {"enable_inference_dropout": True},
                "diffusion": {"forward_conditioning": "none", **diffusion}}

    def save(cfg, path, seed):
        dm = interface.get_datamodule(cfg)
        exp = interface.get_experiment(cfg, dm, device=device, seed=seed)
        torch.save({"params": {k: v.detach().cpu() for k, v in exp.model.state_dict().items()},
                    "ema_params": None, "config_json": json.dumps(cfg)}, path)
        names = list(exp.out_packer.names)
        del exp, dm
        return names

    t0 = time.perf_counter()
    save(experiment_cfg("interpolation"), str(d / "ip.ckpt"), 0)
    names = save(experiment_cfg("dyffusion", interpolator_checkpoint_path=str(d / "ip.ckpt")),
                 str(d / "fc.ckpt"), 1)
    ckpt_s = time.perf_counter() - t0
    saved = names[::5]
    fused = dict(use_pallas=True, fused_tail=True, scan_layers=True, compute_dtype="bfloat16",
                 sht_matmul_dtype="bfloat16")
    windows = []
    real_window = DYffusionStepper.run_window

    def recorded(self, *a, **k):
        out = real_window(self, *a, **k)
        windows.append(out[1])
        return out

    out_dir = d / "dyffusion"
    DYffusionStepper.run_window = recorded
    zero_counts()
    try:
        t0 = time.perf_counter()
        res = main_from_config({
            "checkpoint_path": str(d / "fc.ckpt"), "platform": device,
            "n_forward_steps": n_steps, "forward_steps_in_memory": N_STEPS, "n_ensemble": E,
            "preds_dtype": "bfloat16", "experiment_dir": str(out_dir),
            "log_zonal_mean_images": True, "verbose": False, "log_video": True,
            "overrides": {"model": fused, "interpolator_model": fused,
                          "diffusion": {"peel_sampler": True}},
            "data_writer": {"save_prediction_files": True, "save_histogram_files": True,
                            "log_extended_video_netcdfs": True, "time_coarsen_factor": f,
                            "save_raw_prediction_names": saved}})
        sync()
        wall = time.perf_counter() - t0
    finally:
        DYffusionStepper.run_window = real_window
    launches = counts()
    runs["outputs"] = dict(launches=launches)
    check(len(windows) == 2, f"outputs: {len(windows)} windows")
    for k, n in (("K1", 192 * OUT_LAYERS // 8), ("K3", 192 * OUT_LAYERS // 8), ("K2", 0),
                 ("K4", 0)):
        check(launches[k] == 2 * n, f"outputs: {k} launched {launches[k]} times in 2 windows, "
                                    f"expected {n} a {N_STEPS}-step window (phase 7's path)")
    summary = res["summary"]
    # the predictions the writers got: denormalized on the card in the
    # emitted dtype, as the rollout loop does, then widened on the host
    norm = res["stepper"].exp.normalizer.subset(names).to(dev)
    raw = np.concatenate([((p * norm.stds + norm.means).to(p.dtype)).float().cpu().numpy()
                          for p in windows], axis=1)  # (E, T, H, W, C)
    check(raw.shape == (E, n_steps, H, W, len(names)) and bool(np.isfinite(raw).all()),
          f"outputs: predictions {raw.shape}, finite {bool(np.isfinite(raw).all())}")
    coarse = raw.reshape((E, n_steps // f, f) + raw.shape[2:]).mean(axis=2)
    files = {p.name: p.stat().st_size for p in sorted(out_dir.iterdir())}
    check({"autoregressive_predictions.nc", "reduced_autoregressive_predictions.nc",
           "histograms.nc", "videos.nc", "metrics.json"} <= set(files),
          f"outputs: files {sorted(files)}")
    t0 = time.perf_counter()
    bad = []
    with hdf5.File(str(out_dir / "autoregressive_predictions.nc")) as pf:
        kept = sorted(k for k in pf.keys() if k not in ("lat", "lon"))
        check(kept == sorted(saved), f"outputs: prediction file holds {kept}, not {saved}")
        for n in saved:
            i = names.index(n)
            got = pf[n][()]
            if got.shape != (E, n_steps // f, H, W) or not np.array_equal(got, coarse[..., i]):
                bad.append(f"prediction {n}")
        check(pf[saved[0]].attrs["long_name"] == long_name(saved[0]),
              "outputs: long_name attribute")
    with hdf5.File(str(out_dir / "histograms.nc")) as hf:
        for i, n in enumerate(names):
            h = DynamicHistogram(300)
            for w in range(2):
                h.add(raw[:, w * N_STEPS:(w + 1) * N_STEPS, ..., i])
            c, e = hf[f"{n}_counts"][()], hf[f"{n}_edges"][()]
            if (int(c.sum()) != E * n_steps * H * W or not np.array_equal(c, h.counts)
                    or not np.array_equal(e, h.bin_edges)):
                bad.append(f"histogram {n}")
    gen_coarse = coarse.astype(np.float64).mean(axis=0).astype(np.float32)
    with hdf5.File(str(out_dir / "reduced_autoregressive_predictions.nc")) as vf:
        keys = sorted(k for k in vf.keys() if k not in ("lat", "lon"))
        check(keys == sorted(f"{k}-{n}" for k in ("gen_mean", "gen_variance", "target_mean",
                                                 "error_mean") for n in names),
              f"outputs: video file datasets {keys[:5]} ...")
        for i, n in enumerate(names):
            if not np.array_equal(vf[f"gen_mean-{n}"][()], gen_coarse[..., i]):
                bad.append(f"video gen_mean-{n}")
        check(vf[f"gen_mean-{names[0]}"].attrs["dims"] == "time,lat,lon", "outputs: dims")
    gen = raw.astype(np.float64).mean(axis=0).astype(np.float32)
    with hdf5.File(str(out_dir / "videos.nc")) as vf:
        groups = {k: sorted(vf[k].keys()) for k in vf.keys()}
        check(groups == {k: sorted(names) for k in ("gen_mean", "gen_variance", "target_mean",
                                                   "error_mean")},
              f"outputs: videos.nc groups {list(groups)}")
        for i, n in enumerate(names):
            if not np.array_equal(vf[f"gen_mean/{n}"][()], gen[..., i]):
                bad.append(f"videos.nc gen_mean/{n}")
    check_s = time.perf_counter() - t0
    metrics = json.loads((out_dir / "metrics.json").read_text())
    finite = all(np.isfinite(v) for k, v in metrics.items() if k.startswith("inference/"))
    log(f"(a) run_inference, DYffusion at {OUT_EMBED} x {OUT_LAYERS} on {H} x {W}, ensemble {E}, "
        f"bf16, the fused-tail path (K1 and K3 from overrides['model']), {n_steps} steps in "
        f"{N_STEPS}-step windows, every data_writer option, time_coarsen_factor {f}, "
        f"{len(saved)} of {len(names)} names saved, log_video: {wall:.2f} s with loading "
        f"(checkpoints written in {ckpt_s:.2f} s), total "
        f"{summary['total_steps_per_second']:.3f} steps/s, time/writer_and_aggregator "
        f"{summary['time/writer_and_aggregator']:.3f} s; launches {launches}; files "
        + ", ".join(f"{k} {v / 1e6:.1f} MB" for k, v in files.items())
        + f"; read back through data/hdf5.py in {check_s:.2f} s: the prediction file equals the "
        f"recorded predictions coarsened by {f} in numpy, every histogram's counts sum to the "
        f"{E * n_steps * H * W} values and equal DynamicHistogram's over the same windows, "
        f"with its edges, the video file's gen_mean equals the coarsened ensemble mean and "
        f"videos.nc holds one dataset per key and name, its gen_mean the ensemble mean: "
        f"{'all equal' if not bad else 'differ: ' + ', '.join(bad[:6])}; metrics finite "
        f"{finite}; on {smi_line}")
    check(not bad and finite, f"outputs: {bad[:6]}, metrics finite {finite}")
    # the plots, read back: each PNG's pixels are the aggregator's maps
    # through the colour mapping of evaluation/plots.py
    def png_row(p, t):
        p, t = np.asarray(p, np.float64), np.asarray(t, np.float64)
        vmin, vmax = np.percentile(t, [2, 98])
        e = p - t
        return np.concatenate([plots.colorize(p, vmin, vmax, "viridis"),
                               plots.colorize(t, vmin, vmax, "viridis"),
                               plots.colorize(e, np.nanmin(e), np.nanmax(e), "RdBu_r")], axis=1)

    agg, png_bad, n_png = res["aggregator"], [], 0
    for step, snap in agg.snapshots.snapshots.items():
        got = plots.read_png(str(out_dir / "snapshots" / f"snapshot_t{step}.png"))
        want = np.concatenate([png_row(snap["preds"][..., i], snap["targets"][..., i])
                               for i in range(min(4, len(names)))], axis=0)
        n_png += 1
        if not np.array_equal(got, want):
            png_bad.append(f"snapshot_t{step}")
    pz, tz = agg.zonal.get_maps()
    for i, n in enumerate(names[:4]):
        got = plots.read_png(str(out_dir / "zonal_means" / f"zonal_mean_{n}.png"))
        n_png += 1
        if not np.array_equal(got, png_row(pz[..., i].T, tz[..., i].T)):
            png_bad.append(f"zonal_mean_{n}")
    log(f"(a) the plots: {n_png} PNGs (snapshot steps {sorted(agg.snapshots.snapshots)}, the "
        f"zonal means of the first 4 names) read back through evaluation/plots.py:read_png: "
        f"{'equal to the aggregator maps coloured' if not png_bad else png_bad}")
    check(n_png >= 5 and not png_bad, f"outputs: plots {n_png}, {png_bad}")
    rep["dyffusion"] = dict(steps=n_steps, ensemble=E, coarsen=f, wall_s=wall, pngs=n_png,
                            launches=launches, files=files, check_s=check_s,
                            writer_and_aggregator_s=summary["time/writer_and_aggregator"],
                            total_steps_per_second=summary["total_steps_per_second"])
    del res, windows, raw, coarse, gen, gen_coarse, norm, agg, pz, tz
    torch.cuda.empty_cache()

    # (b) ACE: a native checkpoint of ace_bench's float32 stepper (erf gelu,
    # exact norms), the kernels from the run config's overrides, the
    # prediction file against on_window's predictions
    st = main_path.build_ace(embed=OUT_EMBED, layers=OUT_LAYERS, dtype="float32",
                             img_shape=OUT_SHAPE, exact=True, device=device)
    out_names = list(st.cfg.out_names)
    path = str(d / "ace.ckpt")
    torch.save({"stepper": ace_native_state(st, OUT_SHAPE)}, path)
    del st
    handed = []
    real_run = ace_stepper.run_ace_inference

    def on_window(start, out):
        handed.append(torch.stack([out.gen_data[n][:, 1:] for n in out_names], -1).clone())

    def hooked(*a, **k):
        return real_run(*a, on_window=on_window, **k)

    sg = {"ak": [0.0] * 9, "bk": list(np.linspace(0.0, 0.1, 9))}
    ace_stepper.run_ace_inference = hooked
    zero_counts()
    try:
        t0 = time.perf_counter()
        res = main_from_config({
            "checkpoint_path": path, "stepper_type": "ace", "platform": device,
            "n_forward_steps": n_steps, "forward_steps_in_memory": N_STEPS,
            "experiment_dir": str(d / "ace"), "verbose": False, "log_zonal_mean_images": False,
            "sigma_coordinates": sg,
            "overrides": {"model": {"use_pallas": True, "fused_tail": True}},
            "data_writer": {"save_prediction_files": True}})
        sync()
        ace_wall = time.perf_counter() - t0
    finally:
        ace_stepper.run_ace_inference = real_run
    ace_launches = counts()
    runs["outputs_ace"] = dict(launches=ace_launches)
    L = OUT_LAYERS
    check(ace_launches["K1"] == ace_launches["K3"] == n_steps * L and len(handed) == 2,
          f"outputs (ACE): launches {ace_launches}, {len(handed)} windows")
    want = torch.cat(handed, dim=1).float().cpu().numpy()  # (1, T, H, W, C)
    with hdf5.File(str(d / "ace" / "autoregressive_predictions.nc")) as pf:
        kept = sorted(k for k in pf.keys() if k not in ("lat", "lon"))
        ace_bad = [n for i, n in enumerate(out_names)
                   if not np.array_equal(pf[n][()], want[..., i])]
    log(f"(b) run_inference, ACE native checkpoint at {OUT_EMBED} x {OUT_LAYERS}, float32, K1 "
        f"and K3 from overrides['model'], {n_steps} steps in {N_STEPS}-step windows with the "
        f"prediction file: {ace_wall:.2f} s with loading, launches {ace_launches}; the file's "
        f"{len(kept)} prognostic fields against on_window's predictions: "
        f"{'equal bit for bit' if not ace_bad and kept == sorted(out_names) else ace_bad[:4]}")
    check(not ace_bad and kept == sorted(out_names), f"outputs (ACE): {ace_bad[:4]}, {kept[:4]}")
    rep["ace"] = dict(steps=n_steps, wall_s=ace_wall, launches=ace_launches,
                      bytes=os.path.getsize(d / "ace" / "autoregressive_predictions.nc"))
    del res, handed, want
    tmp.cleanup()
    torch.cuda.empty_cache()
    report.setdefault("writers", {})["outputs"] = rep


def parity_block_inputs(oracle):
    """Phase 20 (b)'s input to the forecaster, (1, H, W, C_in) float32, and
    its time, from a numpy seed: the same in the oracle's process and here."""
    import numpy as np

    r = np.random.default_rng(20)
    c_in = oracle.sd["encoder.0.weight"].shape[1]
    x = r.standard_normal((1, *oracle.img_shape, c_in)).astype(np.float32)
    t = np.asarray([0.5 * (oracle.min_time + oracle.max_time)], np.float32)
    return x, t


def parity_oracle_child(out_dir: str) -> None:
    """The host half of phase 20, run by ``start_parity_oracle`` in a
    process of its own on the CPU while the card runs the other phases (the
    float64 oracle takes tens of seconds an SFNO forward at 180 x 360):
    fabricates the reference-format checkpoint pair into ``out_dir``, runs
    the oracle's window over the check's inputs and (b)'s forward of the
    forecaster, and writes them to ``oracle.npz`` with their host seconds."""
    import numpy as np
    import torch

    from spherical_dyffusion_tpu_torch.utils import parity_window as pw

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    facts = pw.fabricate_reference_checkpoints(
        out_dir, embed_dim=PARITY_EMBED, num_layers=PARITY_LAYERS, horizon=PARITY_HORIZON,
        img_shape=PARITY_SHAPE)
    fab_s = time.perf_counter() - t0
    fc = facts["forecaster"]
    stepper, config = pw.load_parity_stepper(fc, device="cpu")
    inputs = pw.window_inputs(stepper.exp, config, PARITY_STEPS)
    xf, preds, window_s = pw.oracle_window(fc, stepper.exp, config, inputs, PARITY_STEPS)
    oracle = pw.reference_oracles(fc, PARITY_SHAPE)[0]
    x, t = parity_block_inputs(oracle)
    t0 = time.perf_counter()
    out, acts = oracle.forward(np.moveaxis(x, -1, 1), time=t)
    block_s = time.perf_counter() - t0
    keep = {f"b_{k}": v for k, v in acts.items() if k.startswith("block_") or k == "time_emb"}
    tmp = os.path.join(out_dir, "oracle.tmp.npz")
    np.savez(tmp, xf=xf, preds=preds, window_s=window_s, b_out=out, block_s=block_s,
             fabricate_s=fab_s, **keep)
    os.replace(tmp, os.path.join(out_dir, "oracle.npz"))
    with open(os.path.join(out_dir, "facts.json"), "w") as f:
        json.dump(facts, f)
    print(f"oracle: window {window_s:.1f} s, forward {block_s:.1f} s", flush=True)


def start_parity_oracle():
    """Start ``parity_oracle_child`` in a process of its own (one thread, no
    card) and return ``(process, directory)``; the process is killed at exit
    if it is still running."""
    import atexit
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    d = tempfile.mkdtemp(prefix="chip_smoke_parity_")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(p for p in (here, os.environ.get("PYTHONPATH"))
                                          if p))
    with open(os.path.join(d, "oracle.log"), "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-c", f"import chip_smoke; chip_smoke.parity_oracle_child({d!r})"],
            cwd=here, env=env, stdout=out, stderr=subprocess.STDOUT)

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    atexit.register(stop)
    return proc, d


def phase20(smi_line, wrappers, report, runs, oracle_job, device="cuda") -> None:
    """Phase 20: the port on the card against the float64 oracles, and the
    last utilities. (a) ``run_window_parity_check`` of a fabricated
    reference-format checkpoint pair (PARITY_EMBED x PARITY_LAYERS on
    PARITY_SHAPE, horizon PARITY_HORIZON, PARITY_STEPS steps), loaded through
    ``load_reference_checkpoint`` on the card in float32, with K1 and K3 and
    then with K1 and K2, against the oracle's window computed in another
    process (``start_parity_oracle``), per step within 1e-4; (b)
    ``activation_parity_report`` of one forecaster forward (K1 and K3) per
    block against the oracle; (c) the native packer against numpy on a
    window of phase 18's shape; (d) ``Timers``, ``timing_scope``,
    ``trace_scope`` and ``device_memory_stats`` around the window; (e)
    ``save_orbax`` and ``restore_orbax`` (DCP) of a DCP_EMBED x DCP_LAYERS
    SFNO's state on the card."""
    import collections
    import shutil
    import tempfile

    import numpy as np
    import torch

    from spherical_dyffusion_tpu_torch.data.datasets import pack_normalize
    from spherical_dyffusion_tpu_torch.interface import get_model
    from spherical_dyffusion_tpu_torch.utils import native, orbax_ckpt, profiling
    from spherical_dyffusion_tpu_torch.utils import parity as par
    from spherical_dyffusion_tpu_torch.utils import parity_window as pw

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    rep = {}

    def zero_counts():
        for fn in wrappers.values():
            fn.launches = 0

    def counts():
        return {k: fn.launches for k, fn in wrappers.items()}

    # (a) the window against the float64 oracle
    proc, d = oracle_job
    t0 = time.perf_counter()
    try:
        rc = proc.wait(timeout=ORACLE_WAIT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = None
    waited = time.perf_counter() - t0
    with open(os.path.join(d, "oracle.log")) as f:
        child_log = f.read()
    check(rc == 0, f"parity: the oracle's process ended with {rc}: {child_log[-2000:]}")
    data = np.load(os.path.join(d, "oracle.npz"))
    with open(os.path.join(d, "facts.json")) as f:
        fc = json.load(f)["forecaster"]
    oracle = (data["xf"], data["preds"], float(data["window_s"]))
    log(f"(a) the oracle's process: checkpoints fabricated in {float(data['fabricate_s']):.1f} "
        f"s, its window ({PARITY_STEPS} steps, horizon {PARITY_HORIZON}) {oracle[2]:.1f} s and "
        f"(b)'s forward {float(data['block_s']):.1f} s of host time, on the CPU beside the "
        f"earlier phases; waited {waited:.1f} s for it here")
    L = PARITY_LAYERS
    windows = {}
    for label, over, on in (("K1+K3", PARITY_K3, ("K1", "K3")), ("K1+K2", PARITY_K2, ("K1", "K2"))):
        zero_counts()
        try:
            r = pw.run_window_parity_check(fc, n_steps=PARITY_STEPS, tol=1e-4, device=device,
                                           model_overrides=over, oracle=oracle, verbose=False)
        except AssertionError as e:
            check(False, f"parity ({label}): {e}")
        c = counts()
        log(f"(a) {label}: {PARITY_EMBED} x {L} on {PARITY_SHAPE[0]} x {PARITY_SHAPE[1]}, "
            f"float32, the reference checkpoint loaded on the card: per-step max |diff| "
            + ", ".join(f"{v:.3e}" for v in r["per_step_max_abs_diff"])
            + f", final state {r['final_state_max_abs_diff']:.3e} (tolerance 1e-4; largest "
            f"prediction {r['pred_scale']:.3f}); the card's window {r['port_s']:.3f} s; "
            f"launches {c}")
        check(c[on[0]] > 0 and c[on[0]] == c[on[1]] and c[on[0]] % L == 0
              and all(v == 0 for k, v in c.items() if k not in on),
              f"parity ({label}): launches {c}")
        key = "parity" if label == "K1+K3" else "parity_k2"
        runs[key] = dict(launches=c)
        windows[label] = dict(per_step_max_abs_diff=r["per_step_max_abs_diff"],
                              final_state_max_abs_diff=r["final_state_max_abs_diff"],
                              pred_scale=r["pred_scale"], port_s=r["port_s"], launches=c)
    rep["window"] = dict(embed=PARITY_EMBED, layers=L, shape=list(PARITY_SHAPE),
                         horizon=PARITY_HORIZON, steps=PARITY_STEPS, tol=1e-4,
                         oracle_host_s=oracle[2], waited_s=waited, **windows)

    # (b) one forecaster forward, block by block
    fc_oracle = pw.reference_oracles(fc, PARITY_SHAPE)[0]
    model = par.load_reference_sfno(fc_oracle.sd, PARITY_SHAPE, device=device,
                                    min_time=fc_oracle.min_time, max_time=fc_oracle.max_time,
                                    **PARITY_K3)
    x, t = parity_block_inputs(fc_oracle)
    reference = (data["b_out"], {k[2:]: data[k] for k in data.files
                                 if k.startswith("b_block_") or k == "b_time_emb"})
    zero_counts()
    block = par.activation_parity_report(model, fc_oracle, x, time=t, reference=reference)
    c = counts()
    log("(b) activation_parity_report, one forecaster forward with K1 and K3 on the card: "
        + ", ".join(f"{k} {v['max_abs']:.3e} (rel {v['rel']:.3e})" for k, v in block.items())
        + f"; the oracle's forward {float(data['block_s']):.1f} s of host time; launches {c}")
    check(c["K1"] == c["K3"] == L and c["K2"] == c["K4"] == 0, f"parity (b): launches {c}")
    try:
        par.assert_activation_parity(block)
    except AssertionError as e:
        check(False, f"parity (b): {e}")
    rep["blocks"] = block
    del model

    # (c) the native packer on a window of phase 18's shape: the state
    # unnormalized, the forcings normalized
    with open(os.path.join(os.path.dirname(os.path.abspath(native.__file__)), "..", "configs",
                           "datamodule", "fv3gfs.json")) as f:
        fv3 = json.load(f)
    r = np.random.default_rng(18)
    frames = (N_STEPS + 1,) + tuple(DATA_SHAPE)
    state = [(r.standard_normal(frames) * 10 + 280).astype(np.float32) for _ in fv3["in_names"]]
    forcing = [(r.standard_normal(frames) * 100 + 300).astype(np.float32)
               for _ in fv3["forcing_names"]]
    means = np.float32([300.0, 250.0][:len(forcing)])
    stds = np.float32([90.0, 110.0][:len(forcing)])
    packer = {}
    for name, fn in (("native", native.pack_normalize), ("numpy", pack_normalize)):
        times, outs = [], None
        for _ in range(3):
            t0 = time.perf_counter()
            outs = (fn(state), fn(forcing, means, stds))
            times.append(time.perf_counter() - t0)
        packer[name] = (outs, 1e3 * float(np.median(times)))
    same = all(np.array_equal(a, b) for a, b in zip(packer["native"][0], packer["numpy"][0]))
    nbytes = sum(a.nbytes for a in packer["native"][0])
    log(f"(c) the native packer on a {N_STEPS + 1}-frame window of phase 18's shape "
        f"({len(state)} state fields, {len(forcing)} normalized forcings on {DATA_SHAPE[0]} x "
        f"{DATA_SHAPE[1]}, {nbytes / 1e6:.1f} MB out): {packer['native'][1]:.2f} ms against "
        f"numpy's {packer['numpy'][1]:.2f} ms (median of 3), "
        f"{'bit for bit equal' if same else 'DIFFERENT'}; on the host of {smi_line}")
    check(same, "parity (c): the native packer differs from the numpy version")
    rep["packer"] = dict(ms=packer["native"][1], numpy_ms=packer["numpy"][1], bytes=nbytes)
    del packer, state, forcing

    # (d) Timers, timing_scope, trace_scope and device_memory_stats around
    # the K1+K3 window
    stepper, config = pw.load_parity_stepper(fc, model_overrides=PARITY_K3, device=device)
    inputs = pw.window_inputs(stepper.exp, config, PARITY_STEPS)
    dev = torch.device(device)
    args = [torch.from_numpy(a).to(dev) if a is not None else None
            for a in (inputs["x0_norm"], inputs["forcing_norm"], inputs["tgt_norm"],
                      inputs["mask"])]

    def window():
        with torch.no_grad():
            return stepper.run_window(*args, torch.Generator(device=dev).manual_seed(0),
                                      PARITY_STEPS)

    window()
    sync()
    timers = profiling.Timers(sync=True)
    for _ in range(2):
        with timers("window"):
            window()
    logged = []

    class Collect:
        def log(self, metrics, step=None):
            logged.append(metrics)

    with profiling.timing_scope("window", verbose=False, logger=Collect(), sync=True):
        window()
    summary = timers.summary()
    check(list(summary) == ["time/window", "time/window_mean"] and summary["time/window"] > 0
          and list(logged[0]) == ["time/window"], f"parity (d): {summary}, {logged}")
    trace_dir = os.path.join(os.path.dirname(os.path.abspath(native.__file__)), "..", "build",
                             "chip_smoke_trace")
    with profiling.trace_scope(trace_dir):
        window()
        sync()
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    k1 = sum("dhconv_tc_kernel" in n for n in names)
    k3 = sum(bool(re.search(r"fused_mlp(_tc)?_kernel<true", n)) for n in names)
    trace_bytes = os.path.getsize(os.path.join(trace_dir, "trace.json"))
    shutil.rmtree(trace_dir)
    stats = profiling.device_memory_stats()
    gb = 1024 ** 3
    mem_ok = device != "cuda" or (
        stats["peak_bytes_in_use_gb"] == torch.cuda.max_memory_allocated() / gb
        and stats["bytes_in_use_gb"] == torch.cuda.memory_allocated() / gb)
    log(f"(d) Timers around the window (synchronized): {summary['time/window_mean']:.4f} s a "
        f"window over {timers.counts['window']}, timing_scope {logged[0]['time/window']:.4f} "
        f"s; trace_scope's Chrome trace ({trace_bytes / 1e6:.1f} MB) names {len(names)} kernel "
        f"launches, {k1} of them K1 (dhconv_tc_kernel) and {k3} K3 (fused_mlp_kernel<true>); "
        f"device_memory_stats {stats} against torch.cuda.max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / gb if device == 'cuda' else 0:.4f} GB")
    check(device != "cuda" or (k1 > 0 and k3 > 0), f"parity (d): the trace names K1 {k1} and "
                                                   f"K3 {k3} times")
    check(mem_ok, f"parity (d): device_memory_stats {stats}")
    rep["profiling"] = dict(window_s=summary["time/window_mean"],
                            timing_scope_s=logged[0]["time/window"], trace_kernels=len(names),
                            trace_k1=k1, trace_k3=k3, memory=stats)
    del stepper, args

    # (e) DCP save and restore of a DCP_EMBED x DCP_LAYERS SFNO's state on
    # the card
    State = collections.namedtuple("State", "model ema step")

    def sfno(seed):
        return get_model({"kind": "sfno", "embed_dim": DCP_EMBED, "num_layers": DCP_LAYERS},
                         PARITY_SHAPE, 72, 35, True, 0.0, 5.0, device=device,
                         generator=torch.Generator(device=dev).manual_seed(seed))

    src, into = State(sfno(0), sfno(1), 7), State(sfno(2), sfno(3), 0)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dcp_")
    path = os.path.join(tmp, "ckpt")
    sync()
    t0 = time.perf_counter()
    orbax_ckpt.save_orbax(path, src, config={"embed_dim": DCP_EMBED})
    save_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(a, n)) for a, _, ns in os.walk(path) for n in ns)
    t0 = time.perf_counter()
    payload, cfg = orbax_ckpt.restore_orbax(path, into)
    sync()
    restore_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host, _ = orbax_ckpt.restore_orbax(path)
    host_s = time.perf_counter() - t0
    equal = all(torch.equal(a, b) for m, n in ((src.model, into.model), (src.ema, into.ema))
                for a, b in zip(m.state_dict().values(), n.state_dict().values()))
    equal_host = all(torch.equal(v.cpu(), host["params"][k])
                     for k, v in src.model.state_dict().items())
    n_params = sum(p.numel() for p in src.model.parameters())
    log(f"(e) save_orbax/restore_orbax (torch.distributed.checkpoint) of a {DCP_EMBED} x "
        f"{DCP_LAYERS} SFNO on {PARITY_SHAPE[0]} x {PARITY_SHAPE[1]} ({n_params / 1e6:.1f} M "
        f"parameters, params and EMA) from the card: {nbytes / 1e6:.1f} MB written in "
        f"{save_s:.2f} s ({nbytes / 1e9 / save_s:.2f} GB/s), restored onto the card in place in "
        f"{restore_s:.2f} s, to the host in {host_s:.2f} s; "
        f"{'bit for bit equal' if equal and equal_host else 'DIFFERENT'}, step "
        f"{payload['step']}, config {cfg}; on {smi_line}")
    check(equal and equal_host and payload["step"] == 7 and cfg == {"embed_dim": DCP_EMBED},
          "parity (e): the DCP round trip differs")
    rep["dcp"] = dict(bytes=nbytes, save_s=save_s, restore_s=restore_s, host_restore_s=host_s,
                      params=n_params)
    shutil.rmtree(tmp)
    shutil.rmtree(d)
    del src, into, payload, host
    if device == "cuda":
        torch.cuda.empty_cache()
    report["parity"] = rep


def phase22a(smi_line, report, device="cuda") -> None:
    """Phase 22 (a): K1's forward, its dx (K1 over the conjugate-transposed
    image) and dW (``dhconv_wgrad_tc_kernel``) at the skill studies' shapes,
    CI = CO = 64 at the full preset (x (16, 64, 65, 64), W (64, 64, 64))
    and 16 at the mini one (x (8, 16, 17, 16)), float32, against their plain
    versions (1e-5 of the largest entry), with the event-loop and device ms,
    and dW's plan, the same bits on its second call, its ratio to one
    complex ``torch.matmul`` and its times at other splits. At these shapes
    a call is mostly the host's work, which a torch.profiler session leaves
    slower for the rest of the process, so it runs after phase 2, before
    any profiler pass."""
    import torch

    from spherical_dyffusion_tpu_torch.ops.pallas_contractions import (
        conj_transpose,
        dhconv,
        dhconv_plain,
        dhconv_weight_grad,
        dhconv_weight_grad_plain,
        dhconv_weight_image,
    )

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    rep = {}

    def timed_ms(fn, reps, spin=False):
        """ms a call of ``fn`` in a loop of ``reps`` between CUDA events;
        with ``spin``, the calls queued behind a spin kernel (the device's
        time, without the host's work between launches)."""
        fn()
        if not cuda:
            return None
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        ev[0].record()
        for _ in range(reps):
            fn()
        ev[1].record()
        if spin:
            check(not ev[0].query(), "the device reached the timed launches before the host "
                                     "had queued them all; lengthen the spin")
        ev[1].synchronize()
        return ev[0].elapsed_time(ev[1]) / reps

    def rel(got, want):
        d = float((got.float() - want.float()).abs().max())
        return d, d / float(want.float().abs().max())

    # (a) K1's forward, dx and dW at the studies' shapes
    g = torch.Generator(device=dev).manual_seed(22)
    for preset_name, (B, L, M, C) in (("full", (16, 64, 65, 64)), ("mini", (8, 16, 17, 16))):
        x = torch.randn((B, L, M, C, 2), generator=g, device=dev)
        gy = torch.randn((B, L, M, C, 2), generator=g, device=dev)
        w = torch.randn((C, C, L, 2), generator=g, device=dev) / C
        img, wct = dhconv_weight_image(w), conj_transpose(w).contiguous()
        img_t = dhconv_weight_image(w, conj_t=True)
        flops = 8.0 * B * L * M * C * C
        nbytes = 4.0 * (x.numel() + gy.numel() + w.numel())
        bound_ms, bound_by = bound(flops, nbytes, TF32_PEAK)
        # the library yardsticks: one complex torch.matmul each, on operands
        # laid out for it (the layout copies untimed)
        xc, gc = torch.view_as_complex(x), torch.view_as_complex(gy)
        wc = torch.view_as_complex(w.permute(2, 0, 1, 3).contiguous())  # (L, CI, CO)
        wh = wc.conj().transpose(-1, -2).contiguous()
        xk = xc.transpose(0, 1).reshape(L, -1, C).mH.contiguous()  # (L, CI, B M)
        gk = gc.transpose(0, 1).reshape(L, -1, C).contiguous()
        cases = {
            "forward": (lambda: dhconv(x, w, img), lambda: dhconv_plain(x, w),
                        lambda: torch.matmul(xc, wc)),
            "dx": (lambda: dhconv(gy, wct, img_t), lambda: dhconv_plain(gy, conj_transpose(w)),
                   lambda: torch.matmul(gc, wh)),
            "dw": (lambda: dhconv_weight_grad(x, gy), lambda: dhconv_weight_grad_plain(x, gy),
                   lambda: torch.matmul(xk, gk)),
        }
        shape = {}
        for name, (kernel, plain, library) in cases.items():
            got = kernel()
            want = plain()
            abs_err, rel_err = rel(got, want)
            # 200 calls of kernel and library alike: at these shapes a call is
            # mostly the host's work, which 20 calls time poorly
            shape[name] = dict(max_abs_err=abs_err, max_rel_err=rel_err,
                               ms=timed_ms(kernel, 200), device_ms=timed_ms(kernel, 20, spin=True),
                               plain_ms=timed_ms(plain, 5), library_ms=timed_ms(library, 200),
                               bound_ms=bound_ms, bound_by=bound_by)
            if name == "dw":
                check(torch.equal(got, kernel()), f"two calls of dW's kernel differ at "
                                                  f"{(B, L, M, C)}")
                plan = dw_plan(x, gy)
                shape[name].update(plan=plan)
                if cuda:
                    ratio = shape[name]["ms"] / shape[name]["library_ms"]
                    # the plan's choice against others, each through the wrapper
                    plans = [dict(splits=n) for n in sorted({1, 3, 9, plan["splits"]})]
                    by_plan = dw_by_plan(x, gy, want, plans, timed_ms)
                    shape[name].update(vs_library=ratio, by_plan=by_plan)
                    log(f"phase 22 (a) dW at {(B, L, M, C)}: {dw_plan_text(plan)}; the same bits "
                        f"on a second call; dW kernel against complex torch.matmul {ratio:.3f}x; "
                        f"through the wrapper by splits (the plan's choice against others), ms "
                        f"a call in a loop and device ms: {by_plan}")
            log(f"phase 22 (a) K1 {name} at the {preset_name} preset's shape x {(B, L, M, C)} "
                f"x W ({C}, {C}, {L}): max abs err {abs_err:.3e} (rel {rel_err:.3e}, tolerance "
                f"1e-5) against its plain version; {shape[name]['ms']} ms a call in a loop "
                f"({shape[name]['device_ms']} ms on the device, queued behind a spin), plain "
                f"{shape[name]['plain_ms']} ms, complex torch.matmul "
                f"{shape[name]['library_ms']} ms, bound {bound_ms:.4f} ms ({bound_by}); on "
                f"{smi_line}")
            check(rel_err <= 1e-5, f"K1 {name} at {(B, L, M, C)} disagrees with its plain "
                                   "version")
            del got, want
        rep[f"k1_{preset_name}"] = dict(shape=[B, L, M, C, C], **shape)
        del x, gy, w, img, wct, img_t, xc, gc, wc, wh, xk, gk
    report["K1"]["studies"] = {k: v["forward"] for k, v in rep.items()}
    report["K1_bwd"]["studies"] = {k: v["dx"] for k, v in rep.items()}
    report["K1_dw"]["studies"] = {k: v["dw"] for k, v in rep.items()}
    report["studies"] = rep


def phase22(smi_line, wrappers, report, runs, device="cuda") -> None:
    """Phase 22: the skill studies on the card (``scripts/skill_proof.py``
    and ``scripts/ace_skill.py`` of the port), the dense dhconv through K1.
    (a) is ``phase22a``, run before any profiler pass; (b) ``skill_proof``
    at the full preset's widths (64 x 128, 2 channels, embed 64 x 4, batch
    16, horizon 6, ensemble 10, 150 steps an epoch, the OU system, MLP
    dropout 0.15), its depth cut to SKILL_EPOCHS_INTERP + SKILL_EPOCHS_FC
    epochs, a SKILL_ROLLOUT-step rollout and SKILL_N_TIMESTEPS training
    frames (the cuts printed on a ``reduced`` line), its report held to
    ``tests/test_skill.py``'s gates (thresholds below); (c) ``ace_skill
    --configs dense`` at the full preset's widths, ACE_SKILL_EPOCHS epochs
    and SKILL_N_TIMESTEPS frames, ``bounded``; (d) the K1
    launches of every training step, counted by a hook on
    ``Trainer.train_step`` (an interpolator step: 4 forwards, 4 dx, 4 dW; a
    forecaster step: its own 4, 4 and 4 and the frozen interpolator's 4
    forwards; a simultaneous step: 4, 4, 4) and the K1 weight images made
    in each (the trained network's 8, made anew after every update: an
    image served stale across an update would show as fewer), the median
    step ms, each stage's seconds and the peak device memory. K2-K4 are
    not on these paths and launch no time."""
    import tempfile

    import torch

    from spherical_dyffusion_tpu_torch.ops.pallas_contractions import (
        dhconv,
        dhconv_weight_grad,
        dhconv_weight_image,
    )
    from spherical_dyffusion_tpu_torch.scripts import ace_skill, skill_proof
    from spherical_dyffusion_tpu_torch.training.trainer import Trainer

    cuda = torch.device(device).type == "cuda"
    rep = report.setdefault("studies", {})  # phase22a's K1 figures first

    # (d) the hook: K1's launches and images per training step
    counters = (dhconv, "dx_launches"), (dhconv_weight_grad, "launches"), \
        (dhconv_weight_image, "launches")
    steps = []
    train_step = Trainer.train_step

    def counted(self, *a, **k):
        before = [dhconv.launches] + [getattr(f, n) for f, n in counters]
        out = train_step(self, *a, **k)
        after = [dhconv.launches] + [getattr(f, n) for f, n in counters]
        total, dx, dw, images = (b - a for a, b in zip(before, after))
        steps.append((type(self.exp).__name__, (total - dx, dx, dw, images)))
        return out

    def run(main, argv):
        for fn in wrappers.values():
            fn.launches = 0
        dhconv.dx_launches = dhconv_weight_grad.launches = dhconv_weight_image.launches = 0
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        Trainer.train_step = counted
        t0 = time.perf_counter()
        try:
            out = main(argv)
        finally:
            Trainer.train_step = train_step
        seconds = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in wrappers.items()}
        launches.update(dx=dhconv.dx_launches, dw=dhconv_weight_grad.launches)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else None
        for fn in wrappers.values():
            fn.launches = 0
        check(not any(launches[k] for k in ("K2", "K3", "K4")),
              f"the studies launched kernels that are not on their path: {launches}")
        return out, seconds, launches, peak

    platform = [] if cuda else ["--platform=cpu"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_skill_") as tmp:
        # (b) skill_proof at the full preset's widths, its depth cut
        argv = platform + [
            f"--preset={SKILL_PRESET}", f"--out={tmp}/skill",
            f"--epochs-interp={SKILL_EPOCHS_INTERP}",
            f"--epochs-fc={SKILL_EPOCHS_FC}", f"--rollout-steps={SKILL_ROLLOUT}",
            f"--n-timesteps={SKILL_N_TIMESTEPS}"]
        log(f"reduced: skill_proof --preset={SKILL_PRESET} at its widths, {SKILL_EPOCHS_INTERP} + "
            f"{SKILL_EPOCHS_FC} epochs (the preset's 24 + 24), a {SKILL_ROLLOUT}-step "
            f"rollout (504) and {SKILL_N_TIMESTEPS} training frames (8192); {' '.join(argv)}")
        r, sp_s, sp_launches, sp_peak = run(skill_proof.main, argv)
        i, c, n, ro = r["interpolator"], r["cold_sampling"], r["naive_sampling"], r["rollout"]
        H = r["params"]["horizon"]
        log(f"reduced: {r['timing']['interpolator']['steps'] // SKILL_EPOCHS_INTERP} steps an "
            f"epoch ({r['params']['steps_per_epoch']} where the training frames allow them)")
        gates = {
            "interpolator val RMSE < SKILL_INTERP_VS_CLIM x climatology":
                i["val_rmse"] < SKILL_INTERP_VS_CLIM * i["baseline_rmse_climatology"],
            "interpolator train loss down by 1 - SKILL_LOSS_DROP":
                i["train_loss"][-1] < SKILL_LOSS_DROP * i["train_loss"][0],
            "h1 RMSE < SKILL_H1_VS_CLIM x climatology":
                c["h1/rmse"] < SKILL_H1_VS_CLIM * c["h1/rmse_climatology"],
            "every table value finite": all(math.isfinite(v) for t in (c, n) for v in t.values()),
            "h1 CRPS < h1 RMSE": c["h1/crps"] < c["h1/rmse"],
            f"cold h{H} CRPS <= SKILL_COLD_VS_NAIVE x naive":
                c[f"h{H}/crps"] <= SKILL_COLD_VS_NAIVE * n[f"h{H}/crps"],
            "rollout stable": bool(ro["stable"]),
        }
        t = r["timing"]
        log(f"phase 22 (b) skill_proof at the {SKILL_PRESET} preset's widths: interpolator val "
            f"RMSE "
            f"{i['val_rmse']:.4f} (climatology {i['baseline_rmse_climatology']:.4f}, linear "
            f"{i['baseline_rmse_linear_interp']:.4f}), CRPS {i['val_crps']:.4f}, SSR "
            f"{i['val_ssr']:.4f}, train loss {[round(v, 4) for v in i['train_loss']]}; cold h1 "
            f"RMSE {c['h1/rmse']:.4f} CRPS {c['h1/crps']:.4f} SSR {c['h1/ssr']:.3f}, h{H} RMSE "
            f"{c[f'h{H}/rmse']:.4f} CRPS {c[f'h{H}/crps']:.4f} SSR {c[f'h{H}/ssr']:.3f}; naive "
            f"h1 RMSE {n['h1/rmse']:.4f} CRPS {n['h1/crps']:.4f}, h{H} RMSE "
            f"{n[f'h{H}/rmse']:.4f} CRPS {n[f'h{H}/crps']:.4f}; calibration pass "
            f"{r['calibration']['pass']}; rollout max {ro['max_abs_normalized']:.3f} (data "
            f"{ro['data_max_abs_normalized']:.3f}) stable {ro['stable']}; {sp_s:.2f} s "
            f"(interpolator {t['interpolator']['seconds']:.2f} s at "
            f"{t['interpolator']['step_ms']:.3f} ms a step, forecaster "
            f"{t['forecaster']['seconds']:.2f} s at {t['forecaster']['step_ms']:.3f} ms a step, "
            f"evaluation {t['eval_s']:.2f} s, rollout {t['rollout_s']:.2f} s; training set "
            f"{t['interpolator']['upload']['bytes'] / 2 ** 30:.3f} GiB, read and pinned in "
            f"{t['interpolator']['upload']['host_s']:.2f} s (pinning "
            f"{t['interpolator']['upload']['pin_s']} s), copied in "
            f"{t['interpolator']['upload']['copy_s']} s), peak "
            f"{sp_peak} GiB; on {smi_line}")
        for what, ok in gates.items():
            log(f"  gate {what}: {ok}")
        check(all(gates.values()), f"skill_proof at the full preset's widths failed a gate: "
                                   f"{[k for k, v in gates.items() if not v]}")
        sp_steps = list(steps)
        steps.clear()

        # (c) ace_skill's dense config at the full preset's widths
        argv = platform + [f"--preset={SKILL_PRESET}", "--configs=dense", f"--out={tmp}/ace",
                           f"--epochs={ACE_SKILL_EPOCHS}", f"--n-timesteps={SKILL_N_TIMESTEPS}"]
        log(f"reduced: ace_skill --preset={SKILL_PRESET} --configs=dense at its widths, "
            f"{ACE_SKILL_EPOCHS} epochs (the preset's 24) and {SKILL_N_TIMESTEPS} training "
            f"frames (8192); {' '.join(argv)}")
        a, ace_s, ace_launches, ace_peak = run(ace_skill.main, argv)
        e = a["configs"]["dense"]
        log(f"phase 22 (c) ace_skill dense: per-lead RMSE {e['rmse_per_lead']} (climatology "
            f"{e['rmse_climatology_per_lead']}), max |state| {e['max_abs_normalized']:.3f}, "
            f"bounded {e['bounded']}; {ace_s:.2f} s (training {e['train_s']} s at "
            f"{e['step_ms']:.3f} ms a step), peak {ace_peak} GiB; on {smi_line}")
        check(e["bounded"], "ace_skill's dense rollout is not bounded")
        ace_steps = list(steps)

    # (d) per step: (K1 forwards, dx, dW, images)
    nl = r["params"]["layers"]  # one K1 contraction a block
    expected = {"InterpolationExperiment": (nl, nl, nl),
                "DYffusionForecastingExperiment": (2 * nl, nl, nl),
                "SimultaneousForecastingExperiment": (nl, nl, nl)}
    per_step = {}
    for kind, counts in sp_steps + ace_steps:
        per_step.setdefault(kind, []).append(counts)
    for kind, counts in per_step.items():
        kinds = sorted({c[:3] for c in counts})
        images = [c[3] for c in counts]
        log(f"phase 22 (d) {kind}: {len(counts)} steps, K1 (forwards, dx, dW) a step {kinds}, "
            f"weight images a step {sorted(set(images))} (first step {images[0]})")
        check(kinds == [expected[kind]], f"{kind}: K1 launches a step {kinds}, expected "
                                         f"{expected[kind]}")
        check(min(images) >= 2 * nl, f"{kind}: a step made {min(images)} K1 weight images: a "
                                     "stale image served across an update")
    check(set(per_step) == set(expected), f"the studies trained {sorted(per_step)}")
    rep["skill_proof"] = dict(
        seconds=sp_s, peak_gb=sp_peak, gates=gates, launches=sp_launches, timing=r["timing"],
        interpolator={k: v for k, v in i.items() if k != "train_loss"},
        train_loss=i["train_loss"], cold={k: c[k] for k in ("h1/rmse", "h1/crps", "h1/ssr",
                                                            f"h{H}/rmse", f"h{H}/crps",
                                                            f"h{H}/ssr")},
        naive={k: n[k] for k in ("h1/rmse", "h1/crps", f"h{H}/rmse", f"h{H}/crps")},
        calibration=r["calibration"], rollout={k: v for k, v in ro.items()
                                               if k != "max_abs_normalized_per_window"})
    rep["ace_skill"] = dict(seconds=ace_s, peak_gb=ace_peak, launches=ace_launches,
                            dense={k: v for k, v in e.items() if k != "upload"})
    rep["per_step"] = {k: dict(steps=len(v), k1_forward_dx_dw=list(v[-1][:3]),
                               images_first=v[0][3], images_last=v[-1][3])
                       for k, v in per_step.items()}
    for name, launches in (("skill_proof", sp_launches), ("ace_skill", ace_launches)):
        runs[name] = dict(launches={k: launches[k] for k in ("K1", "K2", "K3", "K4")})
    for key, sub in (("K1_bwd", "dx"), ("K1_dw", "dw")):
        report[key]["launches"] = report[key].get("launches", 0) + sp_launches[sub] + \
            ace_launches[sub]
        report[key]["launches_studies"] = sp_launches[sub] + ace_launches[sub]
    report["studies"] = rep


def event_ms(fn, reps: int, spin: bool = False) -> float:
    """ms a call of ``fn`` in a loop of ``reps`` between CUDA events, after
    one untimed call; with ``spin``, the calls queued behind a spin kernel
    (the device's time, without the host's work between launches)."""
    import torch

    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    if spin:
        torch.cuda._sleep(SPIN_CYCLES)
    ev[0].record()
    for _ in range(reps):
        fn()
    ev[1].record()
    if spin:
        check(not ev[0].query(), "the device reached the timed launches before the host had "
                                 "queued them all; lengthen the spin")
    ev[1].synchronize()
    return ev[0].elapsed_time(ev[1]) / reps


def phase23(smi_line, wrappers, report, runs, drive, other, device="cuda") -> None:
    """Phase 23: float16. (a) K2 (dropout off and on), K3 at batch 1 and 2
    and K4 at the fast window's shape, float16 instances, against their
    plain versions (``F16_TOL``) with their ms, bounds and the float16
    ``torch.matmul`` (``torch.bmm``) chains' ms; (b) the window path (K1 +
    K2), the fused-tail path (K1 + K3) and the float16 fast window (K4) at
    ``dtype="float16"``, one counted 12-step window each with dropout live
    (``drive``); (c) each with dropout off against the float32 plain path
    from the same weights: its error at most ``F16_WINDOW_VS_PLAIN`` times
    the float16 plain path's own. ``other`` is the model-driven channels."""
    import gc

    import torch
    import torch.nn.functional as F

    from spherical_dyffusion_tpu_torch import main_path
    from spherical_dyffusion_tpu_torch.ops.fused_mlp import (
        fused_block_tail,
        fused_block_tail_plain,
        fused_mlp,
        fused_mlp_plain,
        weight_image,
        weight_image_plain,
    )
    from spherical_dyffusion_tpu_torch.ops.fused_rank import fused_rank, fused_rank_plain
    from spherical_dyffusion_tpu_torch.ops.sht import InverseRealSHT, RealSHT

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    f16 = torch.float16
    rep = {}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def errs(got, want):
        d = float((got.float() - want.float()).abs().max())
        return d, d / float(want.float().abs().max())

    def same_drops(y, want, what):
        """The kernel drops the plain version's elements. A kept float16
        output below 2^-25 rounds to 0, and the two versions differ by up to
        the tolerance, so where one output is 0 and the other is not, the
        other must lie within F16_TOL of the largest |plain| of 0; returns
        the count of such elements."""
        diff = (y == 0) ^ (want == 0)
        near = torch.maximum(y.float().abs(), want.float().abs()) <= \
            F16_TOL * float(want.float().abs().max())
        check(bool((near | ~diff).all()), f"{what} float16 dropout mask differs from the plain")
        return int(diff.sum())

    # (a) the kernels: the main path's MLP widths, the fast window's K4 shape
    N, C, Hd = F16_SHAPE[0] * F16_SHAPE[1], F16_EMBED, 2 * F16_EMBED
    g = torch.Generator(device=dev).manual_seed(23)
    w1 = torch.randn((C, Hd), device=dev, generator=g) / 16
    w2 = torch.randn((Hd, C), device=dev, generator=g) / 22
    b1 = torch.randn(Hd, device=dev, generator=g) * 0.1
    b2 = torch.randn(C, device=dev, generator=g) * 0.1
    w1h, w2h, b1h, b2h = w1.half(), w2.half(), b1.half(), b2.half()
    flops1 = 2.0 * N * (C * Hd + Hd * C)
    img = weight_image(w1, w2, f16)
    sync()
    check(torch.equal(img, weight_image_plain(w1, w2).to(f16)),
          "the float16 weight repack differs from its plain permutation")
    x = torch.randn((N, C), device=dev, generator=g).half()
    res = torch.randn((N, C), device=dev, generator=g)
    xi = torch.randn((2 * N, C), device=dev, generator=g).half()
    k2_cases = {
        "residual f32 (the forecaster's call)": (x, dict(residual=res)),
        "no residual, float16 out": (x, {}),
        "float16 residual": (x, dict(residual=res.half())),
        "erf gelu, 77 rows": (x[:77], dict(residual=res[:77], exact_gelu=True)),
        "interpolator call: 129,600 rows, dropout 0.1": (xi, dict(seed=20262301,
                                                                 drop_rate=0.1)),
    }
    k2_err = None
    for name, (xx, kw) in k2_cases.items():
        y = fused_mlp(xx, w1, b1, w2, b2, **kw)
        sync()
        want = fused_mlp_plain(xx, w1, b1, w2, b2, **kw)
        check(y.dtype == want.dtype, f"K2 float16 {name}: dtype {y.dtype} vs {want.dtype}")
        abs_err, rel_err = errs(y, want)
        log(f"K2 float16 {name}: out {y.dtype}, max abs err {abs_err:.3e}, max rel err "
            f"{rel_err:.3e} (tolerance {F16_TOL:g} of max |plain|)")
        check(rel_err <= F16_TOL, f"K2 float16 disagrees with its plain version ({name})")
        if "seed" in kw:
            n = same_drops(y, want, "K2")
            log(f"K2 float16 dropout: the kernel drops the plain version's elements; {n} kept "
                f"outputs within the tolerance of 0 are 0 in one version only")
        k2_err = k2_err or (abs_err, rel_err)
    ms = event_ms(lambda: fused_mlp(x, w1, b1, w2, b2, residual=res), 10)
    plain_ms = event_ms(lambda: fused_mlp_plain(x, w1, b1, w2, b2, residual=res), 3)
    library_ms = event_ms(lambda: F.gelu(torch.matmul(x, w1h) + b1h, approximate="tanh") @ w2h
                          + b2h, 10)
    ms_drop = event_ms(lambda: fused_mlp(xi, w1, b1, w2, b2, seed=20262302, drop_rate=0.1), 10)
    ms_i = event_ms(lambda: fused_mlp(xi, w1, b1, w2, b2), 10)
    nbytes = 2.0 * (x.numel() + w1.numel() + w2.numel()) + 4.0 * (Hd + C + res.numel() + N * C)
    bound_ms, bound_by = bound(flops1, nbytes, BF16_PEAK)
    nb_i = 2.0 * (2 * xi.numel() + w1.numel() + w2.numel()) + 4.0 * (Hd + C)
    bound_i, by_i = bound(2 * flops1, nb_i, BF16_PEAK)
    log(f"K2 float16 (64800,256)->512->256, f32 residual: kernel {ms:.4f} ms (bf16: "
        f"{report['K2']['ms']:.4f} ms, phase 3), plain {plain_ms:.4f} ms, float16 torch.matmul "
        f"chain {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) on {smi_line}")
    log(f"K2 float16 interpolator call (129600 rows, float16 out): {ms_i:.4f} ms dropout off, "
        f"{ms_drop:.4f} ms dropout 0.1 (bf16: {report['K2']['ms_interp']:.4f} and "
        f"{report['K2']['ms_interp_dropout']:.4f} ms), bound {bound_i:.4f} ms ({by_i})")
    rep["K2"] = dict(max_abs_err=k2_err[0], max_rel_err=k2_err[1], ms=ms, plain_ms=plain_ms,
                     library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                     ms_interp=ms_i, ms_interp_dropout=ms_drop, bound_ms_interp=bound_i)
    del x, xi

    def tail_operands(B):
        return (torch.randn((B, N, C), device=dev, generator=g).half(),
                1.0 + 0.1 * torch.randn((B, 1, C), device=dev, generator=g),
                0.1 * torch.randn((B, 1, C), device=dev, generator=g))

    x1, a1, c1 = tail_operands(1)
    x2, a2, c2 = tail_operands(2)
    res1 = res.reshape(1, N, C)
    k3_err = None
    for name, (xx, aa, cc, kw) in {
            "B=1, f32 residual (the forecaster)": (x1, a1, c1, dict(residual=res1)),
            "B=2, no residual, float16 out (the interpolator)": (x2, a2, c2, {}),
            "B=2, 77 rows a sample, dropout 0.1": (x2[:, :77], a2, c2,
                                                  dict(seed=20262303, drop_rate=0.1))}.items():
        y = fused_block_tail(xx, aa, cc, w1, b1, w2, b2, **kw)
        sync()
        want = fused_block_tail_plain(xx, aa, cc, w1, b1, w2, b2, **kw)
        check(y.dtype == want.dtype and y.shape == want.shape,
              f"K3 float16 {name}: {y.dtype} {tuple(y.shape)} vs {want.dtype}")
        abs_err, rel_err = errs(y, want)
        log(f"K3 float16 {name}: out {y.dtype}, max abs err {abs_err:.3e}, max rel err "
            f"{rel_err:.3e} (tolerance {F16_TOL:g} of max |plain|)")
        check(rel_err <= F16_TOL, f"K3 float16 disagrees with its plain version ({name})")
        if "seed" in kw:
            n = same_drops(y, want, "K3")
            log(f"K3 float16 dropout: the kernel drops the plain version's elements; {n} kept "
                f"outputs within the tolerance of 0 are 0 in one version only")
        k3_err = k3_err or (abs_err, rel_err)
    ms = event_ms(lambda: fused_block_tail(x1, a1, c1, w1, b1, w2, b2, residual=res1), 10)
    plain_ms = event_ms(lambda: fused_block_tail_plain(x1, a1, c1, w1, b1, w2, b2,
                                                       residual=res1), 3)
    library_ms = event_ms(lambda: F.gelu(torch.matmul((x1.float() * a1 + c1).half(), w1h) + b1h,
                                         approximate="tanh") @ w2h + b2h + res1, 10)
    ms_b2 = event_ms(lambda: fused_block_tail(x2, a2, c2, w1, b1, w2, b2), 10)
    library_b2 = event_ms(lambda: F.gelu(torch.matmul((x2.float() * a2 + c2).half(), w1h) + b1h,
                                         approximate="tanh") @ w2h + b2h, 10)
    nbytes = 2.0 * (x1.numel() + w1.numel() + w2.numel()) + 4.0 * (
        Hd + C + a1.numel() + c1.numel() + res1.numel() + N * C)
    bound_ms, bound_by = bound(flops1, nbytes, BF16_PEAK)
    nb_b2 = 2.0 * (x2.numel() + w1.numel() + w2.numel() + 2 * N * C) + 4.0 * (
        Hd + C + a2.numel() + c2.numel())
    bound_b2, by_b2 = bound(2 * flops1, nb_b2, BF16_PEAK)
    log(f"K3 float16 B=1, f32 residual: kernel {ms:.4f} ms (bf16: {report['K3']['ms']:.4f} ms, "
        f"phase 4), plain {plain_ms:.4f} ms, affine + float16 torch.matmul chain + residual "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) on {smi_line}")
    log(f"K3 float16 B=2, float16 out: kernel {ms_b2:.4f} ms (bf16: "
        f"{report['K3']['ms_b2']:.4f} ms), chain {library_b2:.4f} ms, bound {bound_b2:.4f} ms "
        f"({by_b2})")
    rep["K3"] = dict(max_abs_err=k3_err[0], max_rel_err=k3_err[1], ms=ms, plain_ms=plain_ms,
                     library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by, ms_b2=ms_b2,
                     library_ms_b2=library_b2, bound_ms_b2=bound_b2, bound_by_b2=by_b2)
    del x1, x2, res, res1, y, want

    k4 = {}
    for B in (1, 2):
        H, L, R = F16_SHAPE[0], int(0.8 * F16_SHAPE[0]), F16_EMBED // 4
        kw = dict(grid="legendre-gauss", matmul_dtype=f16, kernel_layout=True)
        fwd, inv = RealSHT(H, 2 * H, L, L, **kw), InverseRealSHT(H, 2 * H, L, L, **kw)
        A, S = fwd.analysis_mhl.to(dev), inv.synthesis_mhl.to(dev)
        l_first = torch.minimum(fwd.analysis_l_first, inv.synthesis_l_first).to(dev)
        xf = torch.randn((B, H, L, 2 * R, 2), device=dev, generator=g).half()
        Cf = torch.randn((L, R, 2), device=dev, generator=g) * 0.5
        ops = (xf, A, S, Cf, l_first)
        y = fused_rank(*ops)
        sync()
        want = fused_rank_plain(xf, A, S, Cf)
        check(y.dtype == want.dtype == f16 and y.shape == want.shape,
              f"K4 float16 B={B}: {y.dtype} {tuple(y.shape)} vs {want.dtype}")
        abs_err, rel_err = errs(y, want)
        lib_err = errs(k4_library(xf, A, S, Cf), want)[1]
        ms = event_ms(lambda: fused_rank(*ops), 20)
        dev_ms = event_ms(lambda: fused_rank(*ops), 20, spin=True)
        plain_ms = event_ms(lambda: fused_rank_plain(xf, A, S, Cf), 5)
        library_ms = event_ms(lambda: k4_library(xf, A, S, Cf), 20)
        bound_ms, bound_by = k4_bound(*ops)
        bf16 = report["K4"]["ms" if B == 1 else "ms_b2"]
        log(f"K4 float16 fast shape B={B}: max abs err {abs_err:.3e}, max rel err "
            f"{rel_err:.3e} (tolerance {F16_TOL:g}); kernel {ms:.4f} ms ({dev_ms:.4f} ms on the "
            f"device, queued behind a spin; bf16 {bf16:.4f} ms, phase 5), plain "
            f"{plain_ms:.4f} ms, float16 torch.bmm chain {library_ms:.4f} ms (its max rel err "
            f"{lib_err:.3e}), bound over the triangle {bound_ms:.4f} ms ({bound_by}) on "
            f"{smi_line}")
        check(rel_err <= F16_TOL, f"K4 float16 disagrees with its plain version (B={B})")
        k4[B] = dict(max_abs_err=abs_err, max_rel_err=rel_err, ms=ms, device_ms=dev_ms,
                     plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                     bound_by=bound_by)
        del ops, xf, y, want, fwd, inv, A, S
    rep["K4"] = dict(k4[1], **{f"{k}_b2": v for k, v in k4[2].items()})

    # (b) the three float16 paths at full width, counted windows with dropout live
    paths = {
        "window": ({}, dict(use_pallas=False, fused_mlp=False),
                   {"K1": 8, "K2": 8, "K3": 0, "K4": 0}),
        "fused_tail": (dict(use_pallas=True, fused_tail=True, peel=True, scan_layers=True),
                       dict(use_pallas=False, fused_mlp=False, fused_tail=False, peel=True,
                            scan_layers=True),
                       {"K1": 8, "K2": 0, "K3": 8, "K4": 0}),
        "fast": (dict(main_path.FAST_WINDOW_F16), dict(main_path.FAST_WINDOW_F16,
                                                       fused_rank=False),
                 {"K1": 0, "K2": 0, "K3": 0, "K4": 6}),
    }
    inp = main_path.window_inputs(N_STEPS, F16_SHAPE, seed=0, device=device)
    size = dict(embed=F16_EMBED, layers=F16_LAYERS, img_shape=F16_SHAPE)

    def window(st):
        out = st.run_window(inp["x0"], inp["forcing"], inp["sst"], inp["mask"],
                            torch.Generator().manual_seed(3), N_STEPS)
        sync()
        return out[1]

    windows = {}
    for name, (kern_kw, plain_kw, per_forward) in paths.items():
        run = drive(f"float16 {name}", kern_kw, per_forward, dtype="float16")
        runs[f"f16_{name}"] = run
        # (c) dropout off: kernels in float16, the plain path in float16 and
        # in float32 (its float32 form: no spectral-IO emit, as phase 8)
        kern = main_path.build(dtype="float16", device=device, seed=0,
                               enable_interpolator_dropout=False, **size, **kern_kw)
        state = {k: n.state_dict() for k, n in (("f", kern.exp.model),
                                                ("i", kern.exp.interpolator.model))}
        pk = window(kern)
        del kern
        preds = {}
        for dt in ("float16", "float32"):
            kw = dict(plain_kw, spectral_io="") if dt == "float32" and name == "fast" \
                else plain_kw
            plain = main_path.build(dtype=dt, device=device, seed=0,
                                    enable_interpolator_dropout=False, **size, **kw)
            plain.exp.model.load_state_dict(state["f"])
            plain.exp.interpolator.model.load_state_dict(state["i"])
            preds[dt] = window(plain)
            del plain
        check(bool(torch.isfinite(pk).all()), f"float16 {name}: non-finite predictions")
        pp32 = preds["float32"]
        scale = pp32[..., other].abs().max().item()
        err = (pk.float() - pp32).abs().max().item()
        noise = (preds["float16"].float() - pp32).abs().max().item()
        gap = (pk.float() - preds["float16"].float()).abs().max().item()
        log(f"float16 {name}, dropout off: max |kernels f16 - plain f32| {err:.3e} = "
            f"{err / scale:.3e} of the largest model-driven prediction; the float16 plain "
            f"path's own error {noise:.3e} = {noise / scale:.3e}; ratio {err / noise:.3f} "
            f"(tolerance {F16_WINDOW_VS_PLAIN:g}); max |kernels - plain| in float16 {gap:.3e}")
        check(err <= F16_WINDOW_VS_PLAIN * noise,
              f"float16 {name}: the kernels' error exceeds {F16_WINDOW_VS_PLAIN} x the float16 "
              f"plain path's")
        windows[name] = dict(seconds=run["seconds"], steps_per_s=N_STEPS / run["seconds"],
                             bf16_seconds=runs[name]["seconds"], launches=run["launches"],
                             err_vs_f32=err / scale, plain_f16_err_vs_f32=noise / scale,
                             ratio=err / noise)
        log(f"float16 {name} window {run['seconds']:.3f} s against the bf16 window's "
            f"{runs[name]['seconds']:.3f} s (phases 6-8) on {smi_line}")
        del pk, preds, state, pp32
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    report["float16"] = dict(kernels=rep, windows=windows)


def phase24(smi_line, wrappers, report, runs, device="cuda") -> None:
    """Phase 24: the port's ``scripts/rollout_10yr.py`` at 256 x 8 on 180 x
    360, horizon 6, in the variants of ``ROLLOUT10_VARIANTS``, each
    ``ROLLOUT10_STEPS`` steps (two windows of ``ROLLOUT10_WINDOW``) after its
    warm-up window: steps/s, sim-yr/day, the host fractions and
    ``all_steps_finite``, every time-mean log finite, and the kernels'
    launches where a variant routes through them."""
    import tempfile

    import numpy as np

    from spherical_dyffusion_tpu_torch.ops.fused_mlp import weight_image
    from spherical_dyffusion_tpu_torch.ops.pallas_contractions import dhconv_weight_image
    from spherical_dyffusion_tpu_torch.scripts import rollout_10yr

    out = {}
    n_windows = ROLLOUT10_STEPS // ROLLOUT10_WINDOW
    with tempfile.TemporaryDirectory() as tmp:
        for name, (flags, per_forward) in ROLLOUT10_VARIANTS.items():
            args = rollout_10yr.parse_args(
                ["--steps", str(ROLLOUT10_STEPS), "--window", str(ROLLOUT10_WINDOW),
                 "--embed", str(ROLLOUT10_EMBED), "--layers", str(ROLLOUT10_LAYERS),
                 "--device", device, "--out", os.path.join(tmp, name.replace(" ", "_")),
                 *flags])
            t0 = time.perf_counter()
            stepper = rollout_10yr.build_stepper(args)
            windows = []
            real = stepper.run_window

            def run_window(*a, **k):
                windows.append(1)
                return real(*a, **k)

            def zero_counts():
                windows.clear()
                for fn in (*wrappers.values(), weight_image, dhconv_weight_image):
                    fn.launches = 0

            stepper.run_window = run_window
            art = rollout_10yr.rollout_artifact(stepper, args, verbose=False,
                                                before_timed=zero_counts)
            seconds = time.perf_counter() - t0
            launches = {k: fn.launches for k, fn in wrappers.items()}
            tp, hf, num = art["throughput"], art["host_fractions"], art["numerics"]
            log(f"rollout_10yr {name} ({' '.join(flags) or 'defaults'}): {tp['total_steps']} steps "
                f"(cut from 14,600 to two windows of {ROLLOUT10_WINDOW}): "
                f"{tp['steps_per_second']:.3f} steps/s = {tp['sim_years_per_day']:.1f} "
                f"sim-yr/day, steady {tp['steady_steps_per_second']:.3f} steps/s = "
                f"{tp['steady_sim_years_per_day']:.1f} sim-yr/day; host fractions "
                f"data {hf['data_loading']:.4f}, writer+aggregator "
                f"{hf['writer_and_aggregator']:.4f}, device+dispatch "
                f"{hf['device_and_dispatch']:.4f}; all_steps_finite {num['all_steps_finite']}, "
                f"K4 {'on' if art['config']['fused_rank'] else 'off'}; launches {launches}; "
                f"{seconds:.1f} s with its build and warm-up on {smi_line}")
            check(len(windows) == n_windows, f"rollout_10yr {name}: {len(windows)} timed windows")
            check(num["all_steps_finite"] and num["n_metric_rows"] == ROLLOUT10_STEPS,
                  f"rollout_10yr {name}: numerics {num}")
            bad = [k for k, v in art["time_mean_logs"].items() if not np.isfinite(v)]
            check(art["time_mean_logs"] and not bad, f"rollout_10yr {name}: non-finite {bad[:5]}")
            forwards = 2 * ROLLOUT10_STEPS  # 12 SFNO forwards every 6 steps
            for k, n in per_forward.items():
                check(launches[k] == n * forwards,
                      f"rollout_10yr {name}: {k} launched {launches[k]} times in {forwards} "
                      f"SFNO forwards, expected {n} a forward")
            runs[f"rollout_10yr {name}"] = dict(launches=launches)
            out[name] = dict(flags=flags, throughput=tp, host_fractions=hf, numerics=num,
                             fused_rank=art["config"]["fused_rank"], seconds=seconds)
            del stepper, real, run_window
    report["rollout_10yr"] = out


def phase25(smi_line, wrappers, report, runs, device="cuda") -> None:
    """Phase 25: the port's ``scripts/mesh_paper_window.py`` (the paper
    window split over a data x h x w mesh) rank by rank on the card, over
    PyTorch's fake process group: each rank of the mesh is played in turn
    by this process (its group, mesh and stepper made anew, the weights
    built once a program and shared), one untimed and one timed window of
    MPW_STEPS steps of its block at MPW_EMBED x MPW_LAYERS on MPW_SHAPE, B
    = data rows of zeros. No collective moves data, so no value is checked:
    the ranks' footprints and compute seconds are the figures. (a) JAX's
    program (``bench.build``'s defaults: float32, no hand-written kernel,
    the uniform sampler) at data 2 x h 2 x w 2, every rank: its argument,
    output and temp MB, its seconds, its collectives; no kernel launched.
    (b) Phase 7's fused-tail path (K1 and K3, bf16, peeled, ``scan_layers``,
    the interpolator's dropout live) at data 2 x h 2 x w 2 and at the
    four-card layout data 1 x h 2 x w 2: each rank's K1 and K3 launches the
    count of the one-card window (the route launches each once a filter and
    a block tail, over the same forwards at one row a rank) and no K1 image
    in the timed window; its seconds beside phase 7's window and the ratio,
    the ceiling on the speedup without communication. Ranks of one (h, w)
    block give the same footprint. (c) On rank 0 of the four-card layout,
    the window's first K1 and K3 calls captured: one call of each at those
    shapes (the weights captured, K1's image made once as a filter makes
    it; activations seeded) against its plain version, K1 float32 at 1e-5,
    K3 bf16 at 1e-2 of the largest output, with the ms of each."""
    import gc

    import torch

    from spherical_dyffusion_tpu_torch.models import modules as model_modules
    from spherical_dyffusion_tpu_torch.ops.fused_mlp import fused_block_tail_plain
    from spherical_dyffusion_tpu_torch.ops.pallas_contractions import (
        dhconv_plain,
        dhconv_weight_image,
    )
    from spherical_dyffusion_tpu_torch.parallel import distributed_sht
    from spherical_dyffusion_tpu_torch.scripts import mesh_paper_window as mpw

    cuda = torch.device(device).type == "cuda"
    H, W = MPW_SHAPE
    one_card = runs.get("fused_tail", {})
    one_card_s = one_card.get("seconds")
    per_window = {k: one_card.get("launches", {}).get(k, MPW_LAYERS * MPW_FORWARDS)
                  for k in ("K1", "K3")}

    def parse(layout, kernels):
        d, h, w = layout
        argv = ["--embed", str(MPW_EMBED), "--layers", str(MPW_LAYERS), "--img-shape", str(H),
                str(W), "--window", str(MPW_STEPS), "--data", str(d), "--h", str(h), "--w",
                str(w), "--device", device]
        if kernels:
            argv += ["--use-pallas", "--fused-tail", "--peel", "--scan-layers", "--dtype",
                     "bfloat16"]
        return mpw.parse_args(argv)

    def free():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    def spy(module, name, sink):
        """Keep the arguments of the first call of ``module.name``."""
        real = getattr(module, name)

        def call(*a, **k):
            if not sink:
                sink.append((a, k))
            return real(*a, **k)

        setattr(module, name, call)
        return lambda: setattr(module, name, real)

    def mb(v):
        return "n/a" if v is None else f"{v:.1f}"

    def show(what, layout, recs):
        tag = "d{}h{}w{}".format(*layout)
        for r in recs:
            c = r["coords"]
            ratio = one_card_s / r["seconds"] if one_card_s else None
            log(f"mesh_paper_window {what} {tag} rank {r['rank']} (data {c['data']}, h {c['h']}, "
                f"w {c['w']}): blocks x0 {r['blocks']['x0']} preds {r['blocks']['preds']}; "
                f"argument {r['argument_mb']:.1f} MB (parameters {r['params_bytes'] / 1e6:.1f}, "
                f"inputs {r['inputs_bytes'] / 1e6:.1f}), output {r['output_mb']:.1f} MB "
                f"(gathered {r['gathered_output_mb']:.1f}), temp {mb(r['temp_mb'])} MB (peak "
                f"allocated {mb(r['peak_mb'])}, reserved {mb(r['peak_reserved_mb'])}), resident "
                f"before the window {mb(r['resident_mb'])} MB (K1 images "
                f"{r['k1_images_mb']:.1f} MB); {MPW_STEPS} steps in "
                f"{r['seconds']:.3f} s (phase 7's one-card window {one_card_s} s: ratio "
                f"{ratio}); launches {r['launches']}, K1 images {r['k1_images']}; collectives "
                f"(not performed) {({k: v['calls'] for k, v in r['collectives'].items()})} on "
                f"{smi_line}")
        # ranks of one (h, w) block and another data row hold the same footprint
        by_block = {}
        for r in recs:
            by_block.setdefault((r["coords"]["h"], r["coords"]["w"]), []).append(r)
        for same in by_block.values():
            a = same[0]
            for b in same[1:]:
                check((a["argument_bytes"], a["output_bytes"], a["blocks"], a["collectives"])
                      == (b["argument_bytes"], b["output_bytes"], b["blocks"],
                          b["collectives"])
                      and (not cuda or abs(a["temp_mb"] - b["temp_mb"])
                           <= 0.01 * max(a["temp_mb"], b["temp_mb"])),
                      f"mesh_paper_window {what} {tag}: ranks {a['rank']} and {b['rank']} of "
                      f"one block differ in footprint")
        check(all(sum(v["calls"] for v in r["collectives"].values()) > 0 for r in recs),
              f"mesh_paper_window {what} {tag}: a rank called no collective: not split")
        return dict(layout=dict(zip(("data", "h", "w"), layout)), per_rank=recs,
                    argument_mb=max(r["argument_mb"] for r in recs),
                    output_mb=max(r["output_mb"] for r in recs),
                    temp_mb=max(r["temp_mb"] for r in recs) if cuda else None,
                    seconds=max(r["seconds"] for r in recs), one_card_seconds=one_card_s,
                    speedup_ceiling=(one_card_s / max(r["seconds"] for r in recs)
                                     if one_card_s else None))

    out = {}
    # (a) JAX's program at data 2 x h 2 x w 2
    args = parse((2, 2, 2), False)
    t0 = time.perf_counter()
    program = mpw.build_program(args, device)
    build_s = time.perf_counter() - t0
    recs = mpw.fake_ranks(args, program, mpw.window_inputs(args, program, device), warmup=cuda)
    check(all(all(v == 0 for v in r["launches"].values()) for r in recs),
          "mesh_paper_window JAX's program: a hand-written kernel was launched")
    out["jax_program"] = dict(show("JAX's program (float32, plain, uniform sampler)", (2, 2, 2),
                                   recs), build_s=build_s)
    runs["mesh_paper_window plain d2h2w2"] = dict(
        launches={k: sum(r["launches"][k] for r in recs) for k in wrappers})
    del program, recs
    free()

    # (b) the fused-tail path at data 2 x h 2 x w 2 and at the four-card layout
    t0 = time.perf_counter()
    program = mpw.build_program(parse((2, 2, 2), True), device)
    build_s = time.perf_counter() - t0
    k1_call, k3_call = [], []
    for layout in ((2, 2, 2), (1, 2, 2)):
        args = parse(layout, True)
        undo = []
        if layout == (1, 2, 2):  # rank 0 runs first: its warm-up window's first calls
            undo = [spy(distributed_sht, "dhconv", k1_call),
                    spy(model_modules, "fused_block_tail", k3_call)]
        try:
            recs = mpw.fake_ranks(args, program, mpw.window_inputs(args, program, device),
                                  warmup=cuda)
        finally:
            for u in undo:
                u()
        tag = "d{}h{}w{}".format(*layout)
        for r in recs:
            want = dict(per_window, K2=0, K4=0)
            check(not cuda or (all(r["launches"][k] == n for k, n in want.items())
                               and r["k1_images"] == 0),
                  f"mesh_paper_window fused-tail {tag} rank {r['rank']}: launches "
                  f"{r['launches']}, K1 images {r['k1_images']}; expected {want} (the one-card "
                  f"window's) and no image")
        log(f"mesh_paper_window fused-tail {tag}: every rank launched K1 "
            f"{recs[0]['launches']['K1']} and K3 {recs[0]['launches']['K3']} times in its "
            f"window, as the one-card window's {per_window['K1']} and {per_window['K3']}")
        out[f"fused_tail {tag}"] = dict(show("fused-tail (K1 + K3, bf16, peeled)", layout, recs),
                                        build_s=build_s)
        runs[f"mesh_paper_window K1+K3 {tag}"] = dict(
            launches={k: sum(r["launches"][k] for r in recs) for k in wrappers})
        del recs
        free()
    del program
    free()

    # (c) K1 and K3 at the four-card layout's rank 0 shapes
    check(bool(k1_call) and bool(k3_call), "mesh_paper_window: no K1 or K3 call captured")
    g = torch.Generator(device=device).manual_seed(25)
    (x1, w1, *_), _ = k1_call[0]
    x = torch.randn(x1.shape, device=device, generator=g)
    w = w1.detach().clone()
    a3, kw3 = k3_call[0]
    # the activations (x, the norm's A and C, the residual) seeded; the weights,
    # the dropout's seed and rate and the block as captured
    fresh = [torch.randn(t.shape, device=device, generator=g).to(t.dtype) if i < 3
             else t.detach().clone() for i, t in enumerate(a3)]
    kw3 = {k: (torch.randn(v.shape, device=device, generator=g).to(v.dtype)
               if k == "residual" and v is not None else v) for k, v in kw3.items()}
    with torch.no_grad():
        image = dhconv_weight_image(w) if cuda else None  # made once, as the filter's cache
        got, want = wrappers["K1"](x, w, image), dhconv_plain(x, w)
        got3 = wrappers["K3"](*fresh, **kw3)
        want3 = fused_block_tail_plain(*fresh, **kw3)
    k1_err = float((got - want).abs().max() / want.abs().max())
    k3_err = float((got3.float() - want3.float()).abs().max() / want3.float().abs().max())
    k1_ms = k1_plain_ms = k3_ms = k3_plain_ms = None
    if cuda:
        torch.set_grad_enabled(False)
        k1_ms = event_ms(lambda: wrappers["K1"](x, w, image), 10)
        k1_plain_ms = event_ms(lambda: dhconv_plain(x, w), 3)
        k3_ms = event_ms(lambda: wrappers["K3"](*fresh, **kw3), 10)
        k3_plain_ms = event_ms(lambda: fused_block_tail_plain(*fresh, **kw3), 3)
        torch.set_grad_enabled(True)
    block = kw3.get("block")
    log(f"mesh_paper_window d1h2w2 rank 0: K1 at the window's first call's shape x "
        f"{tuple(x.shape)}, w {tuple(w.shape)} (the 'w' channel shard): max rel err against its "
        f"plain version {k1_err:.3e} (tolerance 1e-5), {k1_ms} ms (plain {k1_plain_ms} ms); K3 "
        f"at x {tuple(fresh[0].shape)} {fresh[0].dtype}, block {block}, drop rate "
        f"{kw3.get('drop_rate')}: max rel err {k3_err:.3e} (tolerance 1e-2), {k3_ms} ms (plain "
        f"{k3_plain_ms} ms) on {smi_line}")
    check(k1_err <= 1e-5, "mesh_paper_window: K1 at the split window's shape disagrees")
    check(k3_err <= 1e-2, "mesh_paper_window: K3 at the split window's shape disagrees")
    out["kernels"] = {
        "K1": dict(x=list(x.shape), w=list(w.shape), max_rel_err=k1_err, ms=k1_ms,
                   plain_ms=k1_plain_ms),
        "K3": dict(x=list(fresh[0].shape), dtype=str(fresh[0].dtype),
                   block=None if block is None else [block.h0, block.w0, *block.local],
                   drop_rate=kw3.get("drop_rate"), max_rel_err=k3_err, ms=k3_ms,
                   plain_ms=k3_plain_ms)}
    report.setdefault("K1", {})["mesh_window"] = out["kernels"]["K1"]
    report.setdefault("K3", {})["mesh_window"] = out["kernels"]["K3"]
    del k1_call, k3_call, x, w, image, got, want, fresh, got3, want3
    free()
    report["mesh_paper_window"] = out


def main() -> int:
    t_start = time.perf_counter()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    try:
        from spherical_dyffusion_tpu_torch import main_path
        from spherical_dyffusion_tpu_torch.data.datasets import SyntheticTimeSeries
        from spherical_dyffusion_tpu_torch.evaluation.aggregators import InferenceAggregator
        from spherical_dyffusion_tpu_torch.inference.loop import InferenceConfig, run_inference
        from spherical_dyffusion_tpu_torch.models.sfno import SFNO
        from spherical_dyffusion_tpu_torch.ops import _cuda, pallas_contractions
        from spherical_dyffusion_tpu_torch.ops.fused_mlp import (
            fused_block_tail,
            fused_block_tail_plain,
            fused_mlp,
            fused_mlp_plain,
            weight_image,
            weight_image_plain,
        )
        from spherical_dyffusion_tpu_torch.ops.fused_rank import fused_rank, fused_rank_plain
        from spherical_dyffusion_tpu_torch.ops.pallas_contractions import (
            conj_transpose,
            dhconv,
            dhconv_plain,
            dhconv_weight_grad,
            dhconv_weight_grad_plain,
            dhconv_weight_image,
            dhconv_weight_image_plain,
        )
        from spherical_dyffusion_tpu_torch.ops.sht import (
            InverseRealSHT,
            RealSHT,
            legendre_l_first,
        )
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing: {e}", file=sys.stderr)
        return 1
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    wrappers = {"K1": dhconv, "K2": fused_mlp, "K3": fused_block_tail, "K4": fused_rank}

    def timed(fn, reps: int) -> float:
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def wgrad_library_ms(x, gy) -> float:
        """dW's yardstick: one complex ``torch.matmul``, conj(x)^T g per l
        over (b, m), on inputs laid out for it (the layout copies untimed)."""
        L, CI, CO = x.shape[-4], x.shape[-2], gy.shape[-2]
        xk = torch.view_as_complex(x).transpose(0, 1).reshape(L, -1, CI)
        gk = torch.view_as_complex(gy).transpose(0, 1).reshape(L, -1, CO)
        return timed(lambda: torch.matmul(xk.mH, gk), 10)

    def device_ms(fn, reps: int) -> float:
        """Device time per call of ``fn`` (a wrapper that launches one
        kernel): CUDA events around ``reps`` calls queued behind a spin
        kernel of about 0.1 s, so that the host has queued every launch
        before the device reaches the first and the wrapper's host work
        between launches, which a fast kernel may wait on in a plain loop of
        events, does not count; checked by the start event not yet reached
        when the last call returns. (Counting the profiler's records instead
        lost some of a profiling pass's launches in three of four runs.)"""
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        check(not start.query(), "the device reached the timed launches before the host had "
                                 "queued them all; lengthen the spin")
        end.synchronize()
        return start.elapsed_time(end) / reps

    def errs(got, want):
        d = (got.float() - want.float()).abs().max().item()
        return d, d / want.float().abs().max().item()

    with Phase("0 device"):
        kind = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        check(smi.returncode == 0, f"nvidia-smi: {smi.stderr.strip()}")
        smi_line = smi.stdout.strip().splitlines()[0]
        log(f"device: {kind} (count {count}); nvidia-smi: {smi_line}")
        log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
            f"cuda {torch.version.cuda}")
        # phase 20's float64 oracle, on the CPU in a process of its own
        oracle_job = start_parity_oracle()

    with Phase("1 build"):
        info = _cuda.build_info()
        log(f"build: {info['seconds']:.2f} s (cached: {info['cached']}) -> {info['path']}")
        for line in info["ptxas"].splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry", "C7512",
                                       "setmaxnreg")):
                log("  ptxas " + line.strip())
        check("C7512" not in info["ptxas"], "ptxas serialized the wgmma of a bf16 kernel")
        cuobjdump = os.path.join(os.path.dirname(info["nvcc"]), "cuobjdump")
        sass = subprocess.run([cuobjdump, "-sass", info["path"]], capture_output=True,
                              text=True, timeout=300)
        check(sass.returncode == 0, f"cuobjdump: {sass.stderr.strip()[:200]}")
        hgmma, fn = {}, None
        for line in sass.stdout.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
                hgmma[fn] = 0
            elif fn is not None and "HGMMA" in line:
                hgmma[fn] += 1
        for kernel, n in (("dhconv_tc_kernel", 1), ("dhconv_wgrad_tc_kernel", 2),
                          ("fused_mlp_tc_kernel", 8), ("fused_rank_tc_kernel", 4)):
            tc = {k: v for k, v in hgmma.items() if kernel in k}
            for k, v in tc.items():
                log(f"  sass: {v} HGMMA (wgmma) instructions in {k}")
            check(len(tc) == n and all(v > 0 for v in tc.values()),
                  f"the {n} instance(s) of {kernel} should run their products as HGMMA")

    report = {}

    with Phase("11 training (K1 forward and backward, the trainer at 256 x 8)"):
        # (a) K1's backward at the main path's shapes: dx is K1 over the
        # conjugate-transposed image, dW its own kernel (dhconv_wgrad_tc_kernel)
        g = torch.Generator(device=dev).manual_seed(11)
        L, M, CI, CO = 180, 181, 256, 256
        w = torch.randn((CI, CO, L, 2), device=dev, generator=g) / (CI * CO)
        img_t = dhconv_weight_image(w, conj_t=True)
        torch.cuda.synchronize()
        check(torch.equal(img_t, dhconv_weight_image_plain(w, conj_t=True)),
              "the conjugate-transposed K1 image differs from its plain version")
        image_t_ms = timed(lambda: dhconv_weight_image(w, conj_t=True), 5)
        wct = conj_transpose(w).contiguous()  # its forward image is img_t
        bwd, dw_rep = {}, {}
        for B in (1, 2):
            x = torch.randn((B, L, M, CI, 2), device=dev, generator=g)
            gy = torch.randn((B, L, M, CO, 2), device=dev, generator=g)
            xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
            dx, dw = torch.autograd.grad(dhconv(xl, wl), (xl, wl), gy)
            want_dx, want_dw = torch.autograd.grad(dhconv_plain(xl, wl), (xl, wl), gy)
            torch.cuda.synchronize()
            dx_err, dx_rel = errs(dx, want_dx)
            dw_err, dw_rel = errs(dw, want_dw)
            log(f"K1 backward B={B}: dx max abs err {dx_err:.3e} (rel {dx_rel:.3e}), dW max abs "
                f"err {dw_err:.3e} (rel {dw_rel:.3e}) against autograd of the plain version "
                f"(tolerance 1e-5 of the largest entry)")
            check(dx_rel <= 1e-5 and dw_rel <= 1e-5,
                  f"K1's backward disagrees with autograd of its plain version (B={B})")
            ms = timed(lambda: dhconv(gy, wct, img_t), 20)
            dev_ms = device_ms(lambda: dhconv(gy, wct, img_t), 20)
            plain_ms = timed(lambda: dhconv_plain(gy, conj_transpose(w)), 5)
            dw_k = dhconv_weight_grad(x, gy)
            dw_again = dhconv_weight_grad(x, gy)
            dw_p = dhconv_weight_grad_plain(x, gy)
            torch.cuda.synchronize()
            dwk_err, dwk_rel = errs(dw_k, dw_p)
            check(dwk_rel <= 1e-5, f"dW's kernel disagrees with its plain version (B={B})")
            check(torch.equal(dw_k, dw_again), f"two calls of dW's kernel differ (B={B})")
            plan = dw_plan(x, gy)
            del dw_k, dw_again, dw_p
            dw_ms = timed(lambda: dhconv_weight_grad(x, gy), 20)
            dw_dev_ms = device_ms(lambda: dhconv_weight_grad(x, gy), 20)
            dw_plain_ms = timed(lambda: dhconv_weight_grad_plain(x, gy), 5)
            gc = torch.view_as_complex(gy)
            wc = torch.view_as_complex(w.permute(2, 0, 1, 3).contiguous())
            library_ms = timed(lambda: torch.matmul(gc, wc.conj().transpose(-1, -2)), 20)
            xc = torch.view_as_complex(x).detach().requires_grad_()
            wcl = wc.detach().requires_grad_()
            yc = torch.matmul(xc, wcl)
            autograd_ms = timed(lambda: torch.autograd.grad(yc, (xc, wcl), gc,
                                                            retain_graph=True), 10)
            # dW's yardstick: one complex torch.matmul, conj(x)^T g per l
            dw_library_ms = wgrad_library_ms(x, gy)
            flops = 8.0 * B * L * M * CI * CO
            bound_ms, bound_by = bound(flops, 4.0 * (2 * gy.numel() + w.numel()), TF32_PEAK)
            # dW's bound on the yardstick of K1's: the TF32 tensor cores, one
            # pass (three for float32 accuracy as 3xTF32 beside it)
            dw_bytes = 4.0 * (x.numel() + gy.numel() + w.numel())
            dw_bound, dw_by = bound(flops, dw_bytes, TF32_PEAK)
            dw_bound3, dw_by3 = bound(3 * flops, dw_bytes, TF32_PEAK)
            log(f"K1 backward B={B}: dx kernel {ms:.4f} ms a call in a loop through the "
                f"wrapper ({dev_ms:.4f} ms on the device, queued behind a spin), plain {plain_ms:.4f} ms, "
                f"complex torch.matmul {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by}); the backward image {image_t_ms:.4f} ms (once per step per "
                f"filter); dW kernel {dw_ms:.4f} ms ({dw_dev_ms:.4f} ms on the device; "
                f"{dw_plan_text(plan)}; the same bits on a second call), max abs "
                f"err {dwk_err:.3e} (rel {dwk_rel:.3e}) against its plain version (float32 "
                f"torch.bmm, tolerance 1e-5 of the largest entry) at {dw_plain_ms:.4f} ms, "
                f"complex torch.matmul {dw_library_ms:.4f} ms (dW kernel against complex "
                f"torch.matmul {dw_ms / dw_library_ms:.3f}x), its bound {dw_bound:.4f} ms "
                f"({dw_by}; {dw_bound3:.4f} ms as 3xTF32, {dw_by3}); autograd of complex "
                f"torch.matmul (dx and dW) {autograd_ms:.4f} ms "
                f"against dx + dW here {ms + dw_ms:.4f} ms, on {smi_line}")
            bwd[B] = dict(max_abs_err=dx_err, max_rel_err=dx_rel, dw_max_rel_err=dw_rel, ms=ms,
                          device_ms=dev_ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by, dw_ms=dw_ms,
                          dw_bound_ms=dw_bound, dw_bound_ms_3xtf32=dw_bound3,
                          autograd_complex_matmul_ms=autograd_ms)
            dw_rep[B] = dict(max_abs_err=dwk_err, max_rel_err=dwk_rel, ms=dw_ms,
                             device_ms=dw_dev_ms, plain_ms=dw_plain_ms,
                             library_ms=dw_library_ms, bound_ms=dw_bound, bound_by=dw_by,
                             bound_ms_3xtf32=dw_bound3, autograd_complex_matmul_ms=autograd_ms,
                             dx_plus_dw_ms=ms + dw_ms, plan=plan,
                             vs_library=dw_ms / dw_library_ms)
            del x, gy, xl, wl, dx, dw, want_dx, want_dw, gc, wc, xc, wcl, yc
        report["K1_bwd"] = dict(bwd[1], image_t_ms=image_t_ms,
                                **{f"{k}_b2": v for k, v in bwd[2].items()})
        del w, wct, img_t
        # dW on the "w" = 2 and 4 channel shards of the split grid's
        # distributed_dhconv: x (1, L, M, CI / nw), g (1, L, M, CO)
        shards = {}
        for CIs in (CI // 2, CI // 4):
            x = torch.randn((1, L, M, CIs, 2), device=dev, generator=g)
            gy = torch.randn((1, L, M, CO, 2), device=dev, generator=g)
            dw_k = dhconv_weight_grad(x, gy)
            dw_again = dhconv_weight_grad(x, gy)
            dw_p = dhconv_weight_grad_plain(x, gy)
            torch.cuda.synchronize()
            s_err, s_rel = errs(dw_k, dw_p)
            check(s_rel <= 1e-5, f"dW's kernel disagrees with its plain version (CI {CIs})")
            check(torch.equal(dw_k, dw_again), f"two calls of dW's kernel differ (CI {CIs})")
            plan = dw_plan(x, gy)
            del dw_k, dw_again, dw_p
            s_ms = timed(lambda: dhconv_weight_grad(x, gy), 20)
            s_dev = device_ms(lambda: dhconv_weight_grad(x, gy), 20)
            s_plain = timed(lambda: dhconv_weight_grad_plain(x, gy), 5)
            s_lib = wgrad_library_ms(x, gy)
            s_flops = 8.0 * L * M * CIs * CO
            s_bytes = 4.0 * (x.numel() + gy.numel() + CIs * CO * L * 2)
            s_bound, s_by = bound(s_flops, s_bytes, TF32_PEAK)
            s_bound3, s_by3 = bound(3 * s_flops, s_bytes, TF32_PEAK)
            log(f"dW on the \"w\" = {CI // CIs} shard (1, {L}, {M}) x CI {CIs} -> {CO}: kernel "
                f"{s_ms:.4f} ms ({s_dev:.4f} ms on the device; {dw_plan_text(plan)}; the same "
                f"bits on a second call), max abs err {s_err:.3e} (rel "
                f"{s_rel:.3e}) against its plain version at {s_plain:.4f} ms, complex "
                f"torch.matmul {s_lib:.4f} ms (dW kernel against complex torch.matmul "
                f"{s_ms / s_lib:.3f}x), bound {s_bound:.4f} ms ({s_by}; {s_bound3:.4f} "
                f"ms as 3xTF32), on {smi_line}")
            shards[f"ci{CIs}"] = dict(max_abs_err=s_err, max_rel_err=s_rel, ms=s_ms,
                                      device_ms=s_dev, plain_ms=s_plain, library_ms=s_lib,
                                      bound_ms=s_bound, bound_by=s_by, bound_ms_3xtf32=s_bound3,
                                      plan=plan, vs_library=s_ms / s_lib)
            del x, gy
        report["K1_dw"] = dict(dw_rep[1], **{f"{k}_b2": v for k, v in dw_rep[2].items()},
                               shards=shards)
        torch.cuda.empty_cache()

        # (b) the trainer at 256 x 8 on 180 x 360, float32, K1 on: the
        # interpolator, then the forecaster with it frozen in p_losses
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        train = main_path.train_steps(n_steps=TRAIN_STEPS, device="cuda")
        off = {k: wrappers[k].launches for k in ("K2", "K3", "K4")}
        check(not any(off.values()), f"training launched kernels without a backward: {off}")
        log(f"training: {TRAIN_STEPS} steps of each experiment, built and run in "
            f"{time.perf_counter() - t0:.2f} s")
        per_step = {"interpolator": (16, 8), "forecaster": (24, 8)}
        train_report = {}
        for name, rec in train.items():
            steady = rec["step_ms"][2:]
            med = float(np.median(steady))
            split = {p: float(np.median([s[p] for s in rec["split_ms"][2:]]))
                     for p in ("forward", "backward", "optimizer")}
            log(f"training {name}: losses {[round(v, 5) for v in rec['losses']]}; step ms "
                f"{[round(v, 1) for v in rec['step_ms']]}, median after 2 warm-up steps "
                f"{med:.2f} ms = {1e3 / med:.3f} steps/s at batch 1; median split forward "
                f"{split['forward']:.2f}, backward {split['backward']:.2f}, optimizer and EMA "
                f"{split['optimizer']:.2f} ms (CUDA events); peak device memory "
                f"{rec['peak_bytes'] / 1e9:.3f} GB; K1 launches per step {rec['k1_launches']} "
                f"(backward {rec['k1_backward']}), dW launches per step {rec['k1_dw']}, K1 images "
                f"made per step {rec['k1_images']} on {smi_line}")
            check(all(np.isfinite(v) for v in rec["losses"]), f"training {name}: a non-finite loss")
            k1, dx = per_step[name]
            check(all(n == k1 for n in rec["k1_launches"]) and
                  all(n == dx for n in rec["k1_backward"]),
                  f"training {name}: K1 launches {rec['k1_launches']} (backward "
                  f"{rec['k1_backward']}), expected {k1} ({dx}) a step")
            # dW's kernel once per filter of the trained SFNO
            check(all(n == dx for n in rec["k1_dw"]),
                  f"training {name}: dW launches {rec['k1_dw']}, expected {dx} a step")
            # a new forward and backward image per filter after every update;
            # the frozen interpolator's, once, at the forecaster's first step
            images = [16] * TRAIN_STEPS
            if name == "forecaster":
                images[0] += 8
            check(rec["k1_images"] == images,
                  f"training {name}: K1 images per step {rec['k1_images']}, expected {images}")
            train_report[name] = dict(step_ms=med, steps_per_s=1e3 / med, split_ms=split,
                                      peak_gb=rec["peak_bytes"] / 1e9, losses=rec["losses"],
                                      k1_launches=sum(rec["k1_launches"]),
                                      k1_backward=sum(rec["k1_backward"]),
                                      k1_dw=sum(rec["k1_dw"]))
        report["K1_bwd"]["launches"] = sum(r["k1_backward"] for r in train_report.values())
        report["K1_dw"]["launches"] = sum(r["k1_dw"] for r in train_report.values())
        del train, rec  # rec holds the last trainer and its state
        torch.cuda.empty_cache()

        # the interpolator's step with dW's kernel against the same step with
        # dW's plain version patched in here (the package has no switch), in
        # turns: plain, kernel, kernel, plain, TRAIN_STEPS steps each
        tr = main_path.build_training(n_samples=TRAIN_STEPS, forecaster=False,
                                      device="cuda")["interpolator"]
        turns = []
        for plain in (True, False, False, True):
            if plain:
                pallas_contractions.dhconv_weight_grad = dhconv_weight_grad_plain
            try:
                rec = main_path.train_steps(n_steps=TRAIN_STEPS,
                                            trainers={"interpolator": tr})["interpolator"]
            finally:
                pallas_contractions.dhconv_weight_grad = dhconv_weight_grad
            want_dw = [0 if plain else 8] * TRAIN_STEPS
            check(rec["k1_dw"] == want_dw,
                  f"interpolator steps ({'plain' if plain else 'kernel'} dW): dW launches "
                  f"{rec['k1_dw']}, expected {want_dw}")
            turns.append(("plain" if plain else "kernel", float(np.median(rec["step_ms"][2:]))))
            del rec
        step = {k: [v for n, v in turns if n == k] for k in ("kernel", "plain")}
        log(f"interpolator step, median after 2 warm-up steps, dW's kernel against its plain "
            f"version (turns plain, kernel, kernel, plain): "
            f"{', '.join(f'{n} {v:.2f}' for n, v in turns)} ms; kernel {np.mean(step['kernel']):.2f}"
            f" ms against plain {np.mean(step['plain']):.2f} ms, 8 dW launches a kernel step, "
            f"on {smi_line}")
        report["K1_dw"].update(interpolator_step_ms=step["kernel"],
                               interpolator_step_ms_plain_dw=step["plain"],
                               interpolator_turns=turns)
        del tr
        torch.cuda.empty_cache()

        # the same batch 10 times, dropout off, constant lr: the loss at a
        # fixed timestep draw falls
        tr = main_path.build_training(dropout=False, scheduler="constant", n_samples=1,
                                      device="cuda")["interpolator"]
        dyn, cond, _ = tr.upload(next(iter(tr.dm.train_batches(seed=0))))

        def fixed_loss():
            with torch.no_grad():
                return float(tr.exp.train_loss(tr.normalizer.normalize(dyn),
                                               torch.Generator().manual_seed(123),
                                               dynamical_condition=cond)[0])

        before = fixed_loss()
        rep = main_path.train_steps(n_steps=10, repeat=True, trainers={"interpolator": tr})
        after = fixed_loss()
        log(f"repeated batch, dropout off, constant lr 4e-4: the loss at a fixed timestep "
            f"{before:.5f} before, {after:.5f} after 10 steps; the training losses "
            f"{[round(v, 5) for v in rep['interpolator']['losses']]}")
        check(after < before, "training on a repeated batch did not lower its loss")
        del tr, rep, dyn, cond
        torch.cuda.empty_cache()

        # (c) CMP_STEPS steps at constant lr through the kernels against as
        # many through the plain path (use_pallas=False), from the same
        # weights, on the same batches, dropout off, the same generators (so
        # the same timesteps). By the last step the filter weights have moved
        # far from their small initial values, so its loss and gradients
        # lean on K1's forward and dx over the images made after each update.
        kw = dict(dropout=False, scheduler="constant", n_samples=CMP_STEPS, device="cuda")
        fast = main_path.build_training(**kw)
        plain = main_path.build_training(use_pallas=False, **kw)
        for name in fast:
            plain[name].exp.model.load_state_dict(fast[name].exp.model.state_dict())

        def loss_grads(tr, batch, seed):
            """The loss, its gradients, and the trained network's output with
            that output's cotangent (the graph kept for one more product)."""
            outs, cots = [], []

            def keep(module, args, out):
                outs.append(out)
                out.register_hook(cots.append)

            hook = tr.exp.model.register_forward_hook(keep)
            dyn, cond, _ = tr.upload(batch)
            loss, _ = tr.exp.train_loss(tr.normalizer.normalize(dyn),
                                        torch.Generator().manual_seed(seed),
                                        dynamical_condition=cond)
            hook.remove()
            grads = torch.autograd.grad(loss, tr._params, retain_graph=True)
            check(len(outs) == 1 and len(cots) == 1, "one call of the trained network a loss")
            return float(loss.detach()), grads, outs[0], cots[0]

        for name in ("interpolator", "forecaster"):
            ftr, ptr = fast[name], plain[name]
            p0 = [p.detach().clone() for p in ftr.exp.model.parameters() if p.requires_grad]
            names = [n for n, p in ftr.exp.model.named_parameters() if p.requires_grad]
            states = (ftr.init_state(), ptr.init_state())
            lk, lp, gk, gp, flips = [], [], [], [], []
            g_rel = 0.0
            bad, zero = set(), set()
            for s, batch in zip(range(CMP_STEPS), ptr.dm.train_batches(seed=0)):
                lp_s, gp_s, op, cp = loss_grads(ptr, batch, 7 + s)
                lk_s, gk_s, ok, ck = loss_grads(ftr, batch, 7 + s)
                # the L1 loss's sign differs where a prediction meets its
                # target within rounding: there the two paths' output
                # cotangents differ, and the plain path's gradients are taken
                # at the kernels' cotangent (the same product, J^T c)
                delta = ck - cp
                flips.append(int((delta != 0).sum()))
                check(flips[-1] <= max(1, 1e-5 * delta.numel()),
                      f"training {name}: the loss cotangents differ at {flips[-1]} entries")
                gp_at_k = gp_s
                if flips[-1]:
                    vjp = torch.autograd.grad(op, ptr._params, delta)
                    gp_at_k = [a + b for a, b in zip(gp_s, vjp)]
                    del vjp
                del op, ok, cp, ck, delta
                # F5: every parameter a finite gradient and every filter
                # weight a non-zero one, through the kernels
                bad |= {n for n, a in zip(names, gk_s) if not bool(torch.isfinite(a).all())}
                zero |= {n for n, a in zip(names, gk_s)
                         if n.endswith("filter.weight") and float(a.abs().max()) == 0.0}
                top = max(float(b.abs().max()) for b in gp_at_k)
                g_rel = max(g_rel, max(float((a - b).abs().max()) /
                                       max(float(b.abs().max()), 1e-4 * top)
                                       for a, b in zip(gk_s, gp_at_k)))
                del gp_at_k
                lk.append(lk_s)
                lp.append(lp_s)
                gk.append(gk_s)
                gp.append(gp_s)
                for tr, state in zip((ftr, ptr), states):
                    dyn, cond, _ = tr.upload(batch)
                    tr.train_step(state, dyn, cond, torch.Generator().manual_seed(7 + s))
            check(not bad and not zero and sum(n.endswith("filter.weight") for n in names) == 8,
                  f"training {name}: non-finite gradients {sorted(bad)[:3]}, zero filter "
                  f"gradients {sorted(zero)[:3]}")
            l_rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
            # post-step parameters: within 1e-6 plus AdamW's response to the
            # gradient difference measured here (where a gradient entry is
            # rounding, as for a bias that an instance norm removes, the
            # update follows the rounding's sign): per entry lr times the sum
            # over steps of min(2.5, 3 E / (sqrt(v_hat) + eps)), E the largest
            # difference over the steps, v_hat Adam's bias-corrected second
            # moment of the plain gradients (2 E / ... to first order; clipping
            # only raises the effective eps)
            lr = ftr.schedule(0)
            pk = [p.detach() for p in ftr._params]
            pp = [p.detach() for p in ptr._params]
            p_ratio = p_err = moved = 0.0
            n_over = n_all = 0
            for i, (a, b) in enumerate(zip(pk, pp)):
                e = torch.stack([(sk[i] - sp[i]).abs() for sk, sp in zip(gk, gp)]).amax(0)
                v, sens = torch.zeros_like(b), torch.zeros_like(b)
                for t, sp in enumerate(gp, 1):
                    v = 0.999 * v + 0.001 * sp[i] ** 2
                    sens += (3 * e / ((v / (1 - 0.999 ** t)).sqrt() + 1e-8)).clamp(max=2.5)
                d = (a - b).abs()
                p_ratio = max(p_ratio, float((d / (1e-6 + lr * sens)).max()))
                p_err = max(p_err, float(d.max()))
                moved = max(moved, float((b - p0[i]).abs().max()))
                n_over += int((d > 1e-6).sum())
                n_all += d.numel()
            fw = [k for k, n in enumerate(names) if n.endswith("filter.weight")]
            rms = [float(torch.cat([q[k].flatten() for k in fw]).square().mean().sqrt())
                   for q in (p0, pp)]
            log(f"training {name}, {CMP_STEPS} steps at constant lr {lr:g} through the kernels "
                f"against the plain path: losses {[round(v, 6) for v in lk]} vs "
                f"{[round(v, 6) for v in lp]} (max rel {l_rel:.3e}, tolerance 1e-5); L1 signs "
                f"flipped at {flips} output entries a step; gradients, the plain path's taken "
                f"at the kernels' output cotangent, max err {g_rel:.3e} of each tensor's "
                f"largest entry, or of 1e-4 of the network's largest where a tensor's "
                f"gradient cancels below that (tolerance 1e-4), at every step; post-step "
                f"parameters max abs diff {p_err:.3e} ({n_over} of {n_all} entries beyond "
                f"1e-6), {p_ratio:.3f} of the tolerance (1e-6 plus AdamW's response to the "
                f"measured gradient difference); the largest move of a parameter {moved:.3e}, "
                f"the filter weights' rms {rms[0]:.3e} -> {rms[1]:.3e}; all {len(names)} "
                f"gradients finite, the 8 filter weights' non-zero")
            check(l_rel <= 1e-5 and g_rel <= 1e-4 and p_ratio <= 1.0,
                  f"training {name}: the kernels disagree with the plain path")
            train_report[name]["kernels_vs_plain"] = dict(
                steps=CMP_STEPS, lr=lr, loss_rel=l_rel, grad_rel=g_rel, l1_flips=flips,
                param_abs=p_err, param_tol_ratio=p_ratio, params_beyond_1e6=n_over,
                params=n_all, moved=moved)
            del gk, gp, gk_s, gp_s, sp, pk, pp, p0, states, a, b, d, e, v, sens
        # the last loop's trainers and batch too: phase 13 (c) measures its
        # peak memory from an empty card
        del fast, plain, ftr, ptr, tr, state, dyn, cond, batch
        torch.cuda.empty_cache()
        report["training"] = train_report

    runs = {}
    with Phase("12 checkpoints and command lines at 256 x 8"):
        phase12(smi_line, wrappers, report, runs)

    with Phase("2 K1 dhconv"):
        g = torch.Generator(device=dev).manual_seed(0)
        L, M, CI, CO = 180, 181, 256, 256
        w = torch.randn((CI, CO, L, 2), device=dev, generator=g) / (CI * CO)
        img = dhconv_weight_image(w)
        torch.cuda.synchronize()
        check(torch.equal(img, dhconv_weight_image_plain(w)),
              "the K1 weight image kernel differs from its plain version")
        image_ms = timed(lambda: dhconv_weight_image(w), 5)
        log(f"K1 weight image {tuple(img.shape)} float32 (hi and lo, "
            f"{img.numel() * 4 / 1e6:.1f} MB): equal to its plain version; made once per "
            f"model in {image_ms:.4f} ms")
        # a 512-term float32 sum per output, in another order than cuBLAS's,
        # and 3xTF32 drops about 2^-22 of each product
        tol = 1e-5
        k1 = {}
        for B in (1, 2):
            x = torch.randn((B, L, M, CI, 2), device=dev, generator=g)
            y = dhconv(x, w, img)
            torch.cuda.synchronize()
            want = dhconv_plain(x, w)
            abs_err, rel_err = errs(y, want)
            log(f"K1 ({B},{L},{M},{CI})->{CO} f32: max abs err {abs_err:.3e}, "
                f"max rel err {rel_err:.3e} (tolerance {tol:g} of max |plain|)")
            check(rel_err <= tol, f"K1 disagrees with its plain version (B={B})")
            ms = timed(lambda: dhconv(x, w, img), 20)
            dev_ms = device_ms(lambda: dhconv(x, w, img), 20)
            plain_ms = timed(lambda: dhconv_plain(x, w), 5)
            xc = torch.view_as_complex(x)
            wc = torch.view_as_complex(w.permute(2, 0, 1, 3).contiguous())
            library_ms = timed(lambda: torch.matmul(xc, wc), 20)
            flops = 8.0 * B * L * M * CI * CO
            xy_bytes = 4.0 * (x.numel() + y.numel())
            # the function's bound (x, w and y once, its products at the TF32
            # peak); the bound of this algorithm (three TF32 passes over the
            # hi/lo image); and that of a float32 CUDA-core kernel
            bound_ms, bound_by = bound(flops, xy_bytes + 4.0 * w.numel(), TF32_PEAK)
            tc3_ms, tc3_by = bound(3 * flops, xy_bytes + 4.0 * img.numel(), TF32_PEAK)
            simt_ms, simt_by = bound(flops, xy_bytes + 4.0 * w.numel(), F32_PEAK)
            log(f"K1 B={B}: kernel {ms:.4f} ms a call in a loop through the wrapper "
                f"({dev_ms:.4f} ms on the device, queued behind a spin), plain {plain_ms:.4f} ms, complex "
                f"matmul {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
                f"{flops / 1e9:.2f} GFLOP at the TF32 peak, "
                f"{(xy_bytes + 4.0 * w.numel()) / 1e6:.1f} MB), 3xTF32 bound {tc3_ms:.4f} ms "
                f"({tc3_by}; 3 x {flops / 1e9:.2f} GFLOP, "
                f"{(xy_bytes + 4.0 * img.numel()) / 1e6:.1f} MB), float32 CUDA-core bound "
                f"{simt_ms:.4f} ms ({simt_by}) on {smi_line}")
            k1[B] = dict(max_abs_err=abs_err, max_rel_err=rel_err, ms=ms, device_ms=dev_ms,
                         plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                         bound_by=bound_by, bound_ms_3xtf32=tc3_ms, bound_ms_simt=simt_ms)
            del x, y, want, xc, wc
        report["K1"] = dict(k1[1], image_ms=image_ms, **{f"{k}_b2": v for k, v in k1[2].items()})
        del w, img

    N, C, Hd = 180 * 360, 256, 512  # 64,800 rows: the last 64-row tile holds 32
    g = torch.Generator(device=dev).manual_seed(1)
    w1 = torch.randn((C, Hd), device=dev, generator=g) / 16
    w2 = torch.randn((Hd, C), device=dev, generator=g) / 22
    b1 = torch.randn(Hd, device=dev, generator=g) * 0.1
    b2 = torch.randn(C, device=dev, generator=g) * 0.1
    w1b, w2b = w1.bfloat16(), w2.bfloat16()
    b1b, b2b = b1.bfloat16(), b2.bfloat16()
    flops1 = 2.0 * N * (C * Hd + Hd * C)  # one sample's two products
    # bf16 rounding of the hidden tensor may fall on the other side of a
    # tie in the two versions; the outputs then move by about one bf16 ulp
    # of a hidden value times a weight. float32: sums in another order.
    tol_bf16, tol_f32 = 1e-2, 1e-5

    with Phase("22 (a) K1's forward, dx and dW at the skill studies' shapes (before any "
               "profiler pass)"):
        phase22a(smi_line, report)

    with Phase("3 K2 fused MLP"):
        x = torch.randn((N, C), device=dev, generator=g).bfloat16()
        res = torch.randn((N, C), device=dev, generator=g)
        xi = torch.randn((2 * N, C), device=dev, generator=g).bfloat16()  # the double batch
        tol = tol_bf16
        img = weight_image(w1, w2)
        torch.cuda.synchronize()
        check(torch.equal(img, weight_image_plain(w1, w2).to(torch.bfloat16)),
              "the weight repack kernel differs from its plain permutation")
        log(f"K2 weight repack {tuple(img.shape)} bf16: equal to its plain permutation")
        cases = {
            "residual f32 (main path)": dict(residual=res),
            "no residual, bf16 out (main path)": dict(),
            "partial tile, 77 rows": dict(rows=77, residual=res),
            "erf gelu": dict(residual=res, exact_gelu=True),
            "dropout 0.1 on": dict(residual=res, seed=20260101, drop_rate=0.1),
            "interpolator call: 129,600 rows, no residual, dropout 0.1":
                dict(x=xi, seed=20260104, drop_rate=0.1),
        }
        k2_err = None
        for name, kw in cases.items():
            xx = kw.pop("x", x)
            rows = kw.pop("rows", xx.shape[0])
            if "residual" in kw:
                kw["residual"] = kw["residual"][:rows]
            y = fused_mlp(xx[:rows], w1, b1, w2, b2, **kw)
            torch.cuda.synchronize()
            want = fused_mlp_plain(xx[:rows], w1, b1, w2, b2, **kw)
            check(y.dtype == want.dtype, f"K2 {name}: dtype {y.dtype} vs {want.dtype}")
            abs_err, rel_err = errs(y, want)
            log(f"K2 {name}: out {y.dtype}, max abs err {abs_err:.3e}, max rel err "
                f"{rel_err:.3e} (tolerance {tol:g} of max |plain|)")
            check(rel_err <= tol, f"K2 disagrees with its plain version ({name})")
            if "seed" in kw:
                check(torch.equal(y == 0, want == 0), "K2 dropout mask differs from the plain")
            if k2_err is None:
                k2_err = (abs_err, rel_err)

        # dropout statistics: t = round(0.9 * 256) = 230
        t = 230
        p = t / 256
        zero_x = torch.zeros((N, C), device=dev, dtype=torch.bfloat16)
        zres = torch.zeros((N, C), device=dev)
        y = fused_mlp(zero_x, torch.zeros_like(w1), torch.zeros_like(b1), torch.zeros_like(w2),
                      torch.ones_like(b2), residual=zres, seed=7, drop_rate=0.1)
        n = y.numel()
        keep = (y != 0).float().mean().item()
        sigma = (p * (1 - p) / n) ** 0.5
        log(f"K2 output mask: keep rate {keep:.6f} vs {p:.6f} (4 sigma {4 * sigma:.2e}); "
            f"mean of qdrop(1) {y.mean().item():.6f} vs 1 (4 sigma {4 * sigma / p:.2e})")
        check(abs(keep - p) <= 4 * sigma, "K2 output keep rate off by more than 4 sigma")
        check(abs(y.mean().item() - 1.0) <= 4 * sigma / p, "K2 mean of qdrop(1) is biased")
        eye = torch.zeros_like(w2)
        eye[:C] = torch.eye(C, device=dev)
        y = fused_mlp(zero_x, torch.zeros_like(w1), torch.ones_like(b1), eye,
                      torch.zeros_like(b2), residual=zres, seed=8, drop_rate=0.1)
        keep2 = (y != 0).float().mean().item()
        sigma2 = (p * p * (1 - p * p) / n) ** 0.5
        log(f"K2 hidden and output masks: keep rate {keep2:.6f} vs {p * p:.6f} "
            f"(4 sigma {4 * sigma2:.2e})")
        check(abs(keep2 - p * p) <= 4 * sigma2, "K2 hidden keep rate off by more than 4 sigma")

        ms = timed(lambda: fused_mlp(x, w1, b1, w2, b2, residual=res), 10)
        plain_ms = timed(lambda: fused_mlp_plain(x, w1, b1, w2, b2, residual=res), 3)
        library_ms = timed(
            lambda: F.gelu(torch.matmul(x, w1b) + b1b, approximate="tanh") @ w2b + b2b, 10)
        ms_nores = timed(lambda: fused_mlp(x, w1, b1, w2, b2), 10)
        repack_ms = timed(lambda: weight_image(w1, w2), 20)
        nbytes = 2.0 * (x.numel() + w1.numel() + w2.numel()) + 4.0 * (Hd + C) \
            + 4.0 * res.numel() + 4.0 * N * C
        bound_ms, bound_by = bound(flops1, nbytes, BF16_PEAK)
        nb_nores = 2.0 * (x.numel() + w1.numel() + w2.numel() + N * C) + 4.0 * (Hd + C)
        bound_nores, by_nores = bound(flops1, nb_nores, BF16_PEAK)
        log(f"K2 (64800,256)->512->256 bf16, f32 residual: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, torch.matmul chain {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}; {flops1 / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB) on {smi_line}")
        log(f"K2 no residual, bf16 out: kernel {ms_nores:.4f} ms, bound {bound_nores:.4f} ms "
            f"({by_nores}); of each call, the weight repack kernel {repack_ms:.4f} ms")
        # the interpolator's call: the dropout mask is drawn, not read, so
        # the bound is the same with it on
        drop_kw = dict(seed=20260105, drop_rate=0.1)
        ms_i = timed(lambda: fused_mlp(xi, w1, b1, w2, b2), 10)
        ms_i_drop = timed(lambda: fused_mlp(xi, w1, b1, w2, b2, **drop_kw), 10)
        library_i = timed(lambda: F.gelu(torch.matmul(xi, w1b) + b1b, approximate="tanh")
                          @ w2b + b2b, 10)
        nb_i = 2.0 * (2 * xi.numel() + w1.numel() + w2.numel()) + 4.0 * (Hd + C)
        bound_i, by_i = bound(2 * flops1, nb_i, BF16_PEAK)
        philox_share = (ms_i_drop - ms_i) / ms_i_drop
        log(f"K2 interpolator call (129600,256)->512->256, no residual, bf16 out: kernel "
            f"{ms_i:.4f} ms with dropout off, {ms_i_drop:.4f} ms with dropout 0.1 (the Philox "
            f"draws and masks {philox_share:.1%} of it), torch.matmul chain without dropout "
            f"{library_i:.4f} ms, bound {bound_i:.4f} ms ({by_i}; {2 * flops1 / 1e9:.2f} GFLOP, "
            f"{nb_i / 1e6:.1f} MB) on {smi_line}")
        report["K2"] = dict(max_abs_err=k2_err[0], max_rel_err=k2_err[1], ms=ms,
                            plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                            bound_by=bound_by, ms_nores=ms_nores, repack_ms=repack_ms,
                            ms_interp=ms_i, ms_interp_dropout=ms_i_drop,
                            library_ms_interp=library_i, bound_ms_interp=bound_i,
                            philox_share=philox_share)
        del x, res, xi, y, want, zero_x, zres, img

    with Phase("4 K3 fused block tail"):
        g = torch.Generator(device=dev).manual_seed(2)

        def operands(B):
            return (torch.randn((B, N, C), device=dev, generator=g).bfloat16(),
                    1.0 + 0.1 * torch.randn((B, 1, C), device=dev, generator=g),
                    0.1 * torch.randn((B, 1, C), device=dev, generator=g),
                    torch.randn((B, N, C), device=dev, generator=g))

        x1, a1, c1, res1 = operands(1)  # the forecaster's call: f32 residual stream
        x2, a2, c2, res2 = operands(2)  # the interpolator's double batch
        cases = {
            "B=1, f32 residual (forecaster)": (x1, a1, c1, dict(residual=res1), tol_bf16),
            "B=2, no residual, bf16 out (interpolator)": (x2, a2, c2, {}, tol_bf16),
            "B=2, 77 rows per sample (tiles straddle samples)":
                (x2[:, :77], a2, c2, dict(residual=res2[:, :77]), tol_bf16),
            "erf gelu": (x1, a1, c1, dict(residual=res1, exact_gelu=True), tol_bf16),
            "dropout 0.1 on, B=2": (x2, a2, c2, dict(seed=20260102, drop_rate=0.1), tol_bf16),
            "float32 in and out, B=2, 77 rows": (x2[:, :77].float(), a2, c2,
                                                 dict(residual=res2[:, :77]), tol_f32),
        }
        k3_err = None
        for name, (xx, aa, cc, kw, tol) in cases.items():
            y = fused_block_tail(xx, aa, cc, w1, b1, w2, b2, **kw)
            torch.cuda.synchronize()
            want = fused_block_tail_plain(xx, aa, cc, w1, b1, w2, b2, **kw)
            check(y.dtype == want.dtype and y.shape == want.shape,
                  f"K3 {name}: {y.dtype} {tuple(y.shape)} vs {want.dtype} {tuple(want.shape)}")
            abs_err, rel_err = errs(y, want)
            log(f"K3 {name}: out {y.dtype}, max abs err {abs_err:.3e}, max rel err "
                f"{rel_err:.3e} (tolerance {tol:g} of max |plain|)")
            check(rel_err <= tol, f"K3 disagrees with its plain version ({name})")
            if "seed" in kw:
                # no residual: a dropped output element is exactly 0
                dropped = (y == 0).float().mean().item()
                check(torch.equal(y == 0, want == 0), "K3 dropout mask differs from the plain")
                log(f"K3 dropout: the kernel drops the plain version's elements "
                    f"({dropped:.6f} of the outputs)")
            if k3_err is None:
                k3_err = (abs_err, rel_err)
        kw = dict(seed=20260103, drop_rate=0.1)
        y3 = fused_block_tail(x2, torch.ones_like(a2), torch.zeros_like(c2), w1, b1, w2, b2,
                              **kw)
        y2 = fused_mlp(x2.reshape(-1, C), w1, b1, w2, b2, **kw)
        check(torch.equal(y3.reshape(-1, C), y2), "K3 with A = 1, C = 0 differs from K2")
        log("K3 with A = 1, C = 0 equals K2 bit for bit (B=2, dropout on)")

        ms = timed(lambda: fused_block_tail(x1, a1, c1, w1, b1, w2, b2, residual=res1), 10)
        plain_ms = timed(lambda: fused_block_tail_plain(x1, a1, c1, w1, b1, w2, b2,
                                                        residual=res1), 3)
        library_ms = timed(lambda: F.gelu(torch.matmul((x1.float() * a1 + c1).bfloat16(), w1b)
                                          + b1b, approximate="tanh") @ w2b + b2b + res1, 10)
        ms_b2 = timed(lambda: fused_block_tail(x2, a2, c2, w1, b1, w2, b2), 10)
        ms_b2_drop = timed(lambda: fused_block_tail(x2, a2, c2, w1, b1, w2, b2,
                                                    seed=20260106, drop_rate=0.1), 10)
        plain_b2 = timed(lambda: fused_block_tail_plain(x2, a2, c2, w1, b1, w2, b2), 3)
        library_b2 = timed(lambda: F.gelu(torch.matmul((x2.float() * a2 + c2).bfloat16(), w1b)
                                          + b1b, approximate="tanh") @ w2b + b2b, 10)
        nbytes = 2.0 * (x1.numel() + w1.numel() + w2.numel()) + 4.0 * (Hd + C) \
            + 4.0 * (a1.numel() + c1.numel()) + 4.0 * res1.numel() + 4.0 * N * C
        bound_ms, bound_by = bound(flops1, nbytes, BF16_PEAK)
        nb_b2 = 2.0 * (x2.numel() + w1.numel() + w2.numel() + 2 * N * C) + 4.0 * (Hd + C) \
            + 4.0 * (a2.numel() + c2.numel())
        bound_b2, by_b2 = bound(2 * flops1, nb_b2, BF16_PEAK)
        log(f"K3 B=1 (64800,256)->512->256 bf16, f32 residual: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, affine + torch.matmul chain + residual {library_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}; {flops1 / 1e9:.2f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB) on {smi_line}")
        log(f"K3 B=2 no residual, bf16 out: kernel {ms_b2:.4f} ms, plain {plain_b2:.4f} ms, "
            f"affine + torch.matmul chain {library_b2:.4f} ms, bound {bound_b2:.4f} ms "
            f"({by_b2}; {2 * flops1 / 1e9:.2f} GFLOP, {nb_b2 / 1e6:.1f} MB)")
        log(f"K3 B=2 with dropout 0.1: kernel {ms_b2_drop:.4f} ms, bound {bound_b2:.4f} ms "
            f"(the mask is drawn, not read); Philox and masks "
            f"{(ms_b2_drop - ms_b2) / ms_b2_drop:.1%} of it")
        report["K3"] = dict(max_abs_err=k3_err[0], max_rel_err=k3_err[1], ms=ms,
                            plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                            bound_by=bound_by, ms_b2=ms_b2, plain_ms_b2=plain_b2,
                            library_ms_b2=library_b2, bound_ms_b2=bound_b2, bound_by_b2=by_b2,
                            ms_b2_dropout=ms_b2_drop)
        del x1, a1, c1, res1, x2, a2, c2, res2, y, want, y2, y3

    with Phase("5 K4 fused rank pipeline"):
        g = torch.Generator(device=dev).manual_seed(3)

        def rank_operands(B, H, L, M, R, dtype, grid=None):
            """xf (B, H, M, 2R, 2) and the (M, H, L) Legendre matrices of a
            2H-longitude ``grid`` in dtype (random matrices without one), C
            (L, R, 2) float32, and l_first (M,) int32: the transforms' record
            (m on the Legendre grids), or read from random matrices (0)."""
            xf = torch.randn((B, H, M, 2 * R, 2), device=dev, generator=g).to(dtype)
            C = torch.randn((L, R, 2), device=dev, generator=g) * 0.5
            if grid is None:
                A = (torch.randn((M, H, L), device=dev, generator=g) * 0.2).to(dtype)
                S = (torch.randn((M, H, L), device=dev, generator=g) * 0.2).to(dtype)
                l_first = legendre_l_first(A, S)
            else:
                kw = dict(grid=grid, matmul_dtype=dtype, kernel_layout=True)
                fwd, inv = RealSHT(H, 2 * H, L, M, **kw), InverseRealSHT(H, 2 * H, L, M, **kw)
                A, S = fwd.analysis_mhl.to(dev), inv.synthesis_mhl.to(dev)
                l_first = torch.minimum(fwd.analysis_l_first, inv.synthesis_l_first).to(dev)
            return xf, A, S, C, l_first

        cases = {
            "fast shape B=1 bf16 (the forecaster)": ((1, 180, 144, 144, 64), torch.bfloat16,
                                                      "legendre-gauss", tol_bf16),
            "fast shape B=2 bf16 (the interpolator)": ((2, 180, 144, 144, 64), torch.bfloat16,
                                                       "legendre-gauss", tol_bf16),
            "fast shape B=1 float32": ((1, 180, 144, 144, 64), torch.float32,
                                       "legendre-gauss", tol_f32),
            "fast shape B=2 float32": ((2, 180, 144, 144, 64), torch.float32,
                                       "legendre-gauss", tol_f32),
            "prototype shape l=m=181 bf16": ((1, 180, 181, 181, 64), torch.bfloat16,
                                             "equiangular", tol_bf16),
            "prototype shape l=m=181 float32": ((1, 180, 181, 181, 64), torch.float32,
                                                "equiangular", tol_f32),
            "0.25-degree grid h 721 (h in chunks), l=m=144 bf16": (
                (1, 721, 144, 144, 64), torch.bfloat16, "equiangular", tol_bf16),
            "ragged h 37, l=m=29, R 5 bf16": ((2, 37, 29, 29, 5), torch.bfloat16, None, tol_bf16),
            "ragged h 37, l=m=29, R 5 float32": ((2, 37, 29, 29, 5), torch.float32, None,
                                                 tol_f32),
        }
        k4 = {}
        for name, (shape, dtype, grid, tol) in cases.items():
            ops = rank_operands(*shape, dtype, grid)
            y = fused_rank(*ops)
            torch.cuda.synchronize()
            want = fused_rank_plain(*ops[:4])
            check(y.dtype == want.dtype and y.shape == want.shape,
                  f"K4 {name}: {y.dtype} {tuple(y.shape)} vs {want.dtype} {tuple(want.shape)}")
            abs_err, rel_err = errs(y, want)
            log(f"K4 {name}: max abs err {abs_err:.3e}, max rel err {rel_err:.3e} "
                f"(tolerance {tol:g} of max |plain|)")
            check(rel_err <= tol, f"K4 disagrees with its plain version ({name})")
            if name.startswith("fast shape") and dtype == torch.bfloat16:
                lib_err = errs(k4_library(*ops[:4]), want)[1]
                ms = timed(lambda: fused_rank(*ops), 20)
                dev_ms = device_ms(lambda: fused_rank(*ops), 20)
                plain_ms = timed(lambda: fused_rank_plain(*ops[:4]), 5)
                library_ms = timed(lambda: k4_library(*ops[:4]), 20)
                bound_ms, bound_by = k4_bound(*ops)
                dense_ms, _ = k4_bound(*ops, dense=True)
                log(f"K4 {name}: kernel {ms:.4f} ms a call in a loop through the wrapper "
                    f"({dev_ms:.4f} ms on the device, queued behind a spin), plain {plain_ms:.4f} ms, "
                    f"bf16 torch.bmm chain {library_ms:.4f} ms (its max rel err {lib_err:.3e}), "
                    f"bound over the triangle {bound_ms:.4f} ms ({bound_by}), dense bound "
                    f"{dense_ms:.4f} ms on {smi_line}")
                k4[shape[0]] = dict(max_abs_err=abs_err, max_rel_err=rel_err, ms=ms,
                                    device_ms=dev_ms, plain_ms=plain_ms, library_ms=library_ms,
                                    bound_ms=bound_ms, bound_by=bound_by,
                                    bound_ms_dense=dense_ms)
            del ops, y, want
        report["K4"] = dict(k4[1], **{f"{k}_b2": v for k, v in k4[2].items()})

    inp = main_path.window_inputs(N_STEPS, seed=0, device="cuda")
    other = [c for c in range(35) if c != 1]  # the channels the models drive

    def window(st, seed):
        out = st.run_window(inp["x0"], inp["forcing"], inp["sst"], inp["mask"],
                            torch.Generator().manual_seed(seed), N_STEPS)
        torch.cuda.synchronize()
        return out

    def drive(name, path_kw, per_forward, dtype="bfloat16"):
        """Build the path at full width in ``dtype``, warm it up, and run one
        counted, timed 12-step window with dropout live. ``per_forward`` maps
        each kernel to the launches the path must make per SFNO forward."""
        t0 = time.perf_counter()
        stepper = main_path.build(embed=256, layers=8, dtype=dtype, device="cuda", seed=0,
                                  **path_kw)
        log(f"{name} built in {time.perf_counter() - t0:.2f} s")
        nets = {"forecaster": stepper.exp.model, "interpolator": stepper.exp.interpolator.model}
        batches = {k: [] for k in nets}
        for k, net in nets.items():
            net.register_forward_pre_hook(lambda mod, args, k=k: batches[k].append(
                args[0].shape[0]))
        t0 = time.perf_counter()
        window(stepper, 1)  # first window: cuBLAS and allocator warm-up
        log(f"{name} warm-up window: {time.perf_counter() - t0:.2f} s")
        for k in batches:
            batches[k].clear()
        for fn in (*wrappers.values(), weight_image, dhconv_weight_image):
            fn.launches = 0
        t0 = time.perf_counter()
        x_out, preds = window(stepper, 2)
        seconds = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in wrappers.items()}
        check(weight_image.launches == launches["K2"] + launches["K3"],
              f"{name}: {weight_image.launches} weight repacks for "
              f"{launches['K2'] + launches['K3']} 16-bit K2/K3 launches")
        check(dhconv_weight_image.launches == 0,
              f"{name}: {dhconv_weight_image.launches} K1 weight images made in a window after "
              f"the first (each filter makes its image once)")
        forwards = sum(len(b) for b in batches.values())
        log(f"{name} window: {N_STEPS} steps in {seconds:.3f} s = {N_STEPS / seconds:.3f} "
            f"steps/s at batch 1 on {smi_line}")
        log(f"{name} SFNO forwards {forwards}, batch sizes {batches} -> launches {launches}")
        for k, n in per_forward.items():
            want = n * forwards
            check(forwards > 0 and launches[k] == want,
                  f"{name}: {k} launched {launches[k]} times, expected {want}")
        check(preds.shape == (1, N_STEPS, 180, 360, 35), f"preds shape {tuple(preds.shape)}")
        check(bool(torch.isfinite(preds).all()) and bool(torch.isfinite(x_out).all()),
              f"{name}: non-finite predictions")
        return dict(seconds=seconds, forwards=forwards, launches=launches, batches=batches)

    def pair(dtype, path_kw, plain_kw):
        """The same window with dropout off through the kernels and through
        the plain path, same weights; returns (kernels, plain) predictions."""
        kern = main_path.build(dtype=dtype, device="cuda", seed=0,
                               enable_interpolator_dropout=False, **path_kw)
        plain = main_path.build(dtype=dtype, device="cuda", seed=0,
                                enable_interpolator_dropout=False, **plain_kw)
        plain.exp.model.load_state_dict(kern.exp.model.state_dict())
        plain.exp.interpolator.model.load_state_dict(kern.exp.interpolator.model.state_dict())
        t0 = time.perf_counter()
        _, pk = window(kern, 3)
        tk = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, pp = window(plain, 3)
        tp = time.perf_counter() - t0
        check(bool(torch.isfinite(pk).all()), f"non-finite {dtype} predictions")
        log(f"deterministic window {dtype}: kernels {tk:.3f} s, plain path {tp:.3f} s")
        return pk, pp

    with Phase("6 window path (K1, K2, scan sampler)"):
        runs["window"] = drive("window path", {}, {"K1": 8, "K2": 8, "K3": 0, "K4": 0})
        # two horizon-6 segments: one double-batch interpolation per step
        check(runs["window"]["batches"]["interpolator"] == [2] * N_STEPS,
              "the scan sampler should run every interpolation on the double batch")
        # dropout off: kernels against the plain path (K1 -> einsum
        # contraction, K2 -> unfused MLP), same weights, same inputs. The
        # scale is the largest prediction outside the prescribed SST channel
        # (the model-driven values). float32 must agree to float32 rounding;
        # bf16 rounds the MLP at other places in the two paths (once after
        # the fused second product vs after each Dense and its bias), which
        # measured 1-2% of that scale at debug size on the CPU.
        for dtype, tol in (("bfloat16", 5e-2), ("float32", 1e-4)):
            pk, pp = pair(dtype, {}, dict(use_pallas=False, fused_mlp=False))
            scale = pp[..., other].abs().max().item()
            diff = (pk - pp).abs().max().item()
            log(f"window path {dtype}: max |kernels - plain| {diff:.3e} = {diff / scale:.3e} "
                f"of the largest model-driven prediction {scale:.3e} (tolerance {tol:g})")
            check(diff <= tol * scale, f"window path {dtype}: kernels disagree with the plain path")
            del pk, pp

    tail_kw = dict(use_pallas=True, fused_tail=True, peel=True, scan_layers=True)
    with Phase("7 fused-tail path (K1, K3, peeled sampler)"):
        runs["fused_tail"] = drive("fused-tail path", tail_kw,
                                   {"K1": 8, "K2": 0, "K3": 8, "K4": 0})
        # per segment: single-batch ends, the double batch in between
        check(runs["fused_tail"]["batches"]["interpolator"] == ([1] + [2] * 4 + [1]) * 2,
              "the peeled sampler's interpolator batches are not 1, 2, 2, 2, 2, 1 per segment")
        plain_kw = dict(use_pallas=False, fused_mlp=False, fused_tail=False, peel=True,
                        scan_layers=True)
        pk32, pp32 = pair("float32", tail_kw, plain_kw)
        scale = pp32[..., other].abs().max().item()
        diff = (pk32 - pp32).abs().max().item()
        log(f"fused-tail path float32: max |kernels - plain| {diff:.3e} = {diff / scale:.3e} "
            f"of the largest model-driven prediction {scale:.3e} (tolerance 1e-4)")
        check(diff <= 1e-4 * scale, "fused-tail path float32: kernels disagree with the plain path")
        del pk32
        pk, pp = pair("bfloat16", tail_kw, plain_kw)
        gap = (pk - pp).abs().max().item()
        noise = (pp - pp32).abs().max().item()
        log(f"fused-tail path bf16: max |kernels - plain| {gap:.3e} = {gap / scale:.3e} of the "
            f"largest model-driven prediction; the plain path's own bf16 error "
            f"max |plain bf16 - plain float32| {noise:.3e} = {noise / scale:.3e}; ratio "
            f"{gap / noise:.3f} (tolerance {BF16_TAIL_VS_PLAIN:g})")
        check(gap <= BF16_TAIL_VS_PLAIN * noise,
              "fused-tail path bf16: kernels disagree with the plain path")
        del pk, pp, pp32

    fast_kw = dict(main_path.FAST_WINDOW)
    with Phase("8 fast window (K4, CP rank pipeline, peeled sampler)"):
        # blocks 1-6 take the rank pipeline; blocks 0 and 7 change grid and
        # contract in spectral space; the block MLP is unfused
        runs["fast"] = drive("fast window", fast_kw, {"K1": 0, "K2": 0, "K3": 0, "K4": 6})
        check(runs["fast"]["launches"]["K4"] == 144, "the fast window should launch K4 144 x")
        check(runs["fast"]["batches"]["interpolator"] == ([1] + [2] * 4 + [1]) * 2,
              "the peeled sampler's interpolator batches are not 1, 2, 2, 2, 2, 1 per segment")
        # dropout off, K4 against the plain path (same weights, fused_rank
        # off). K4 computes in float32 throughout or rounds like bf16 matmul
        # dtype with bf16 spectral IO, so the float32 pair runs without the
        # spectral-IO emit; bf16 is held, as the fused-tail path, to a
        # multiple of the plain path's own bf16 error
        f32_kw = dict(fast_kw, spectral_io="")
        pk32, pp32 = pair("float32", f32_kw, dict(f32_kw, fused_rank=False))
        scale = pp32[..., other].abs().max().item()
        diff = (pk32 - pp32).abs().max().item()
        log(f"fast window float32: max |kernels - plain| {diff:.3e} = {diff / scale:.3e} "
            f"of the largest model-driven prediction {scale:.3e} (tolerance 1e-4)")
        check(diff <= 1e-4 * scale, "fast window float32: K4 disagrees with the plain path")
        del pk32
        pk, pp = pair("bfloat16", fast_kw, dict(fast_kw, fused_rank=False))
        gap = (pk - pp).abs().max().item()
        noise = (pp - pp32).abs().max().item()
        log(f"fast window bf16: max |kernels - plain| {gap:.3e} = {gap / scale:.3e} of the "
            f"largest model-driven prediction; the plain path's own bf16 error "
            f"max |plain bf16 - plain float32| {noise:.3e} = {noise / scale:.3e}; ratio "
            f"{gap / noise:.3f} (tolerance {BF16_TAIL_VS_PLAIN:g})")
        check(gap <= BF16_TAIL_VS_PLAIN * noise, "fast window bf16: K4 disagrees with the plain path")
        del pk, pp, pp32

    with Phase("10 rollout (run_inference, aggregator, 96-step windows)"):
        names = main_path.state_names()
        rollout_kw = dict(embed=256, layers=8, dtype="bfloat16", device="cuda", seed=0,
                          params_dtype="bfloat16", preds_dtype="bfloat16", **tail_kw)
        ema_net = SFNO(main_path.sfno_configs(fused_tail=True, scan_layers=True)[1]).to(dev)
        ema_net.init_weights(torch.Generator(device=dev).manual_seed(1))
        rollout_kw["ema_params"] = ema_net.state_dict()
        t0 = time.perf_counter()
        stepper = main_path.build(**rollout_kw)
        del ema_net
        log(f"rollout stepper built in {time.perf_counter() - t0:.2f} s (EMA forecaster from "
            f"seed 1, weights rounded to bf16, bf16 predictions)")
        last = {}
        run = stepper.run_window

        def record_state(*args, **kwargs):
            out = run(*args, **kwargs)
            last["x"] = out[0]
            return out

        stepper.run_window = record_state

        def zero_counts():
            for fn in (*wrappers.values(), weight_image, dhconv_weight_image):
                fn.launches = 0

        t0 = time.perf_counter()
        summary, agg = main_path.product_rollout(stepper, n_steps=ROLLOUT_STEPS,
                                                 window=ROLLOUT_WINDOW, before_timed=zero_counts)
        logs = agg.get_logs()
        del agg
        launches = {k: fn.launches for k, fn in wrappers.items()}
        n_windows = ROLLOUT_STEPS // ROLLOUT_WINDOW
        per_window = {k: v / n_windows for k, v in launches.items()}
        steady = summary["steady_steps_per_second"]
        log(f"rollout: warm-up window and {ROLLOUT_STEPS} timed steps in "
            f"{time.perf_counter() - t0:.2f} s")
        log(f"rollout {ROLLOUT_STEPS} steps in {n_windows} windows of {ROLLOUT_WINDOW}, batch 1, "
            f"aggregator on: duration {summary['duration_s']:.3f} s, total "
            f"{summary['total_steps_per_second']:.3f} steps/s, steady {steady:.3f} steps/s = "
            f"{steady * 86400 / STEPS_PER_SIM_YEAR:.1f} sim-yr/day; " + ", ".join(
                f"{k} {v:.3f} s" for k, v in summary.items() if k.startswith("time/"))
            + f"; upload cache skips {summary['upload_cache_skips']} on {smi_line}")
        log(f"rollout launches per timed window {per_window}; K1 weight images made in the "
            f"timed windows: {dhconv_weight_image.launches}; K2/K3 weight repacks "
            f"{weight_image.launches}")
        for k, n in (("K1", 1536), ("K2", 0), ("K3", 1536), ("K4", 0)):
            check(launches[k] == n * n_windows,
                  f"rollout: {k} launched {launches[k]} times in {n_windows} windows, "
                  f"expected {n} a window")
        check(dhconv_weight_image.launches == 0,
              f"rollout: {dhconv_weight_image.launches} K1 weight images made in timed windows")
        check(weight_image.launches == launches["K3"], "rollout: one weight repack per K3 launch")
        check(summary["n_forward_steps"] == ROLLOUT_STEPS, f"rollout summary {summary}")
        bad = {k: v for k, v in logs.items() if not np.isfinite(v)}
        check(len(logs) > 0 and not bad, f"rollout: non-finite logs {list(bad)[:5]}")
        check(bool(torch.isfinite(last["x"]).all()), "rollout: non-finite final state")
        log(f"rollout logs: {len(logs)}, all finite; inference/avg/rmse "
            f"{logs['inference/avg/rmse']:.4f}, time-mean rmse of v0 "
            f"{logs['inference/time_mean/rmse/v0']:.4f}; final state finite")
        runs["rollout"] = dict(launches=launches, summary=summary)
        phase10_writer(smi_line, wrappers, report, stepper, zero_counts,
                       dict(summary=summary, logs=logs))

        t0 = time.perf_counter()
        _, agg2 = main_path.product_rollout(stepper, n_steps=N_STEPS, window=N_STEPS,
                                            n_ensemble=2)
        logs2 = agg2.get_logs()
        del agg2
        ens = {k: logs2.get(f"inference/avg/{k}") for k in ("crps", "ssr")}
        check(all(v is not None and np.isfinite(v) for v in ens.values()),
              f"ensemble 2: CRPS and SSR missing or not finite: {ens}")
        log(f"rollout at ensemble 2, {N_STEPS} steps ({time.perf_counter() - t0:.2f} s with its "
            f"warm-up): inference/avg/crps {ens['crps']:.4e}, inference/avg/ssr {ens['ssr']:.4e}")
        stepper.run_window = run
        del stepper, last

        # dropout off: run_inference against run_window chained by hand on
        # inputs read from the source here (the main path's normalizers are
        # the identity, so the raw fields are the normalized inputs)
        det = main_path.build(**dict(rollout_kw, enable_interpolator_dropout=False))
        n_det = 2 * N_STEPS
        src = SyntheticTimeSeries(names + list(main_path.FORCING_NAMES) + [main_path.MASK_NAME],
                                  n_timesteps=n_det + 1)
        outs = []
        run = det.run_window

        def record(*args, **kwargs):
            out = run(*args, **kwargs)
            outs.append(out)
            return out

        det.run_window = record
        agg = InferenceAggregator(names, src.horizontal.area_weights(),
                                  log_zonal_mean_images=False)
        # the source does not repeat, so every window misses the upload
        # cache; the sync debug mode raises on any synchronizing CUDA call
        # (a pageable upload, a device-to-host copy) before the end sync
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            run_inference(det, src, InferenceConfig(n_forward_steps=n_det,
                                                    forward_steps_in_memory=N_STEPS),
                          aggregator=agg, mask_name=main_path.MASK_NAME, verbose=False)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        log(f"dropout off, {n_det} steps, no repeats: run_inference issued no synchronizing "
            f"CUDA call before its end sync (sync debug mode 'error')")
        det.run_window = run
        raw_np = src.read_window(0, n_det + 1, src.names)
        raw = {k: torch.from_numpy(v).to(dev) for k, v in raw_np.items()}
        x = torch.stack([raw[n][0] for n in names], -1)[None]
        forcing = torch.stack([raw[n] for n in main_path.FORCING_NAMES], -1)[None]
        chained = []
        for w in range(2):
            sl = slice(N_STEPS * w, N_STEPS * (w + 1) + 1)
            x, p = det.run_window(x, forcing[:, sl], raw["surface_temperature"][None, sl],
                                  raw[main_path.MASK_NAME][None, sl],
                                  torch.Generator().manual_seed(0), N_STEPS,
                                  apply_inputs_noise=(w == 0))
            chained.append(p)
        torch.cuda.synchronize()
        loop_preds = torch.cat([o[1] for o in outs], dim=1)
        chained = torch.cat(chained, dim=1)
        same = torch.equal(outs[-1][0], x) and torch.equal(loop_preds, chained)
        gap = max(errs(outs[-1][0], x)[1], errs(loop_preds, chained)[1])
        log(f"dropout off, {n_det} steps in two windows: run_inference against chained "
            f"run_window: {'equal bit for bit' if same else 'not bit-equal'}, max gap "
            f"{gap:.3e} of the largest value (tolerance: bit for bit, or 1e-6 if a library "
            f"call is not deterministic)")
        check(same or gap <= 1e-6, "run_inference differs from chained run_window calls")
        # the aggregator's per-step tables against float64 numpy
        p64 = chained[0].float().cpu().numpy().astype(np.float64)
        y64 = np.stack([raw_np[n][1:n_det + 1] for n in names], -1).astype(np.float64)
        lat = src.horizontal.lat
        w64 = np.cos(np.deg2rad(lat))[:, None] * np.ones((1, len(src.horizontal.lon)))
        w64 = (w64 / w64.sum())[None, :, :, None]
        diff = p64 - y64
        ref = {"rmse": np.sqrt((w64 * diff ** 2).sum((1, 2)) / w64.sum()),
               "bias": (w64 * diff).sum((1, 2)) / w64.sum()}
        series = agg.reduced.series()
        for k, want in ref.items():
            got = series[k]
            check(got.shape == want.shape, f"{k} table {got.shape} vs {want.shape}")
            rel = float(np.abs(got - want).max() / np.abs(want).max())
            log(f"aggregator {k} table ({got.shape[0]} steps x {got.shape[1]} channels) against "
                f"float64 numpy: max gap {rel:.3e} of its largest value (tolerance 1e-4)")
            check(rel <= 1e-4, f"aggregator {k} table differs from float64 numpy")
        # run and record hold det's bound method, rollout_kw the EMA weights
        del det, run, record, outs, chained, loop_preds, raw, p64, y64, diff, agg, x, forcing
        del p, rollout_kw

    with Phase("16 the UNet at its published width (forwards, window, training, command "
               "lines, the card against the CPU)"):
        phase16(smi_line, wrappers, report, runs)

    with Phase("17 the parallel path on an NCCL group of one (distributed transforms, "
               "bf16 gradient mean and ZeRO-1 through K1)"):
        phase17(smi_line, wrappers, report, runs)

    with Phase("13 model options at 256 x 8 (Tucker, fold, remat, the other options)"):
        phase13(smi_line, wrappers, report, runs, drive, pair, other)

    with Phase("21 spatial model parallelism (K1 and K4 on the channel shards, K4 on a "
               "block's rows, K2 and K3 at block origins, the fused-tail, fast and folded "
               "windows and every filter option on the spatial route over an NCCL group of "
               "one)"):
        phase21(smi_line, wrappers, report, runs)

    with Phase("14 training modes at 256 x 8 (bf16, bf16 moments, fused, streaming, rollout "
               "validation, histograms, code snapshot)"):
        phase14(smi_line, wrappers, report, runs)

    with Phase("15 the ACE family at 256 x 8 (rollout, kernels, physics, native checkpoint, "
               "simultaneous training)"):
        phase15(smi_line, wrappers, report, runs)

    with Phase("18 the netCDF data layer at 256 x 8 (files, windows, the train and inference "
               "command lines on them, re-scoring)"):
        phase18(smi_line, wrappers, report, runs)

    with Phase("19 the output files at 256 x 8 (DYffusion and ACE through the inference "
               "command line with every writer, read back through data/hdf5.py)"):
        phase19(smi_line, wrappers, report, runs)

    with Phase("20 the port against the float64 oracles (window and blocks), the native "
               "packer, profiling, DCP checkpoints"):
        phase20(smi_line, wrappers, report, runs, oracle_job)

    with Phase("22 the skill studies at the full preset's widths (skill_proof and ace_skill "
               "through K1, launches a training step)"):
        phase22(smi_line, wrappers, report, runs)

    with Phase("23 float16 (K2, K3 and K4's float16 instances; the window, fused-tail and "
               "fast windows at float16 against the float32 plain path)"):
        phase23(smi_line, wrappers, report, runs, drive, other)

    with Phase("24 the port's rollout_10yr at 256 x 8 (plain, K1+K3 in bf16 and float16, "
               "--fast in bf16 and float16)"):
        phase24(smi_line, wrappers, report, runs)

    with Phase("25 the port's mesh_paper_window: every rank of the split paper window in turn "
               "over the fake process group (JAX's program; K1 + K3 at d2h2w2 and d1h2w2)"):
        phase25(smi_line, wrappers, report, runs)

    # the profile runs last: a torch.profiler session leaves a launch cost
    # behind in the process (the UNet's forward, bound by the host's
    # launches at batch 1, took 19.9-21.4 ms before one profiled forward and
    # 33.5-36.2 ms after it; PERF.md, PR 15)
    with Phase("9 profile (one window of each path)"):
        activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=activities):  # the profiler's own start-up, not measured
            torch.ones(1, device=dev).add_(1)
            torch.cuda.synchronize()
        for name, run, path_kw in (("window path", "window", {}),
                                   ("fused-tail path", "fused_tail", tail_kw),
                                   ("fast window", "fast", fast_kw)):
            stepper = main_path.build(embed=256, layers=8, dtype="bfloat16", device="cuda",
                                      seed=0, **path_kw)
            window(stepper, 1)
            t0 = time.perf_counter()
            with profile(activities=activities) as prof:
                window(stepper, 2)
            wall = time.perf_counter() - t0
            events = [e for e in prof.key_averages()
                      if "cuda" in str(getattr(e, "device_type", "")).lower()]
            dev_us = {e.key: (e.count, getattr(e, "self_device_time_total",
                                               getattr(e, "self_cuda_time_total", 0)))
                      for e in events}
            busy = sum(us for _, us in dev_us.values()) / 1e6
            unprofiled = runs[run]["seconds"]
            log(f"{name} profile: {len(events)} CUDA kernels, device kernel time {busy:.3f} s "
                f"= {busy / unprofiled:.1%} of the unprofiled window ({unprofiled:.3f} s; "
                f"{wall:.3f} s with the profiler on); top 10 CUDA kernels by total time:")
            for key, (cnt, us) in sorted(dev_us.items(), key=lambda kv: -kv[1][1])[:10]:
                log(f"  {us / 1e3:10.2f} ms  {us / 1e6 / max(busy, 1e-12):6.1%}  x{cnt:<5d} "
                    f"{key[:110]}")
            groups = {}
            for key, (cnt, us) in dev_us.items():
                group = ("K1 weight image" if "dhconv_weight_image" in key else
                         "K1 dW" if "dhconv_wgrad" in key else
                         "K1" if "dhconv" in key else
                         "K4" if "fused_rank" in key else
                         "K3" if re.search(r"fused_mlp(_tc)?_kernel<true", key) else
                         "K2" if re.search(r"fused_mlp(_tc)?_kernel<false", key) else
                         "K2/K3 weight repack" if "weight_image_kernel" in key else
                         "cuBLAS GEMM" if any(w in key.lower() for w in
                                              ("gemm", "nvjet", "xmma", "cutlass")) else
                         "copies" if "copy" in key.lower() else
                         "reductions" if "reduce" in key.lower() else "other elementwise")
                groups[group] = groups.get(group, 0.0) + us / 1e6
            log(f"{name} kernel time by group: " + ", ".join(
                f"{k} {v:.3f} s ({v / max(busy, 1e-12):.1%})"
                for k, v in sorted(groups.items(), key=lambda kv: -kv[1])))
            del stepper, prof

    sources = {"K1": "spherical_dyffusion_tpu_torch/csrc/dhconv.cu",
               "K2": "spherical_dyffusion_tpu_torch/csrc/fused_mlp.cu",
               "K3": "spherical_dyffusion_tpu_torch/csrc/fused_mlp.cu",
               "K4": "spherical_dyffusion_tpu_torch/csrc/fused_rank.cu"}
    replaces = {"K1": "spherical_dyffusion_tpu/ops/pallas_contractions.py:72",
                "K2": "spherical_dyffusion_tpu/ops/fused_mlp.py:125",
                "K3": "spherical_dyffusion_tpu/ops/fused_mlp.py:212",
                "K4": "scripts/proto_fused_rank.py:94"}
    names = {"K1": "dhconv", "K2": "fused_mlp", "K3": "fused_block_tail", "K4": "fused_rank"}
    own_path = {"K1": "window", "K2": "window", "K3": "fused_tail", "K4": "fast"}
    kernels = []
    for k in ("K1", "K2", "K3", "K4"):
        kernels.append(dict(
            name=names[k], route="cuda", source=sources[k], replaces=replaces[k],
            launches=runs[own_path[k]]["launches"][k],
            launches_by_path={p: r["launches"][k] for p, r in runs.items()},
            kernel_ms=report[k]["ms"], **report[k]))
    # the float16 instances (phase 23), their launches on the float16 paths
    for k in ("K2", "K3", "K4"):
        f16 = report["float16"]["kernels"][k]
        kernels.append(dict(
            name=f"{names[k]} (float16)", route="cuda", source=sources[k],
            replaces=replaces[k], launches=runs[f"f16_{own_path[k]}"]["launches"][k],
            launches_by_path={p: r["launches"][k] for p, r in runs.items()
                              if p.startswith("f16_") or "float16" in p},
            kernel_ms=f16["ms"], **f16))
    # K1 run by the backward for dx (JAX's custom VJP, whose dx is XLA's
    # einsum and whose forward is the Pallas kernel); launches over the
    # training steps of phase 11
    kernels.append(dict(name="dhconv_backward_dx", route="cuda", source=sources["K1"],
                        replaces="spherical_dyffusion_tpu/ops/pallas_contractions.py:94",
                        kernel_ms=report["K1_bwd"]["ms"], **report["K1_bwd"]))
    # dW's own kernel (dhconv_wgrad_tc_kernel), the weight half of the same
    # VJP (XLA's einsums in JAX); launches over the training steps of phase 11
    kernels.append(dict(name="dhconv_backward_dw", route="cuda", source=sources["K1"],
                        replaces="spherical_dyffusion_tpu/ops/pallas_contractions.py:103",
                        kernel_ms=report["K1_dw"]["ms"], **report["K1_dw"]))
    log(f"total wall time {time.perf_counter() - t_start:.1f} s")
    fused_tail_rate = N_STEPS / runs["fused_tail"]["seconds"]
    report["cli"]["inference"]["phase7_fused_tail_steps_per_second"] = fused_tail_rate
    log(f"inference command line: steady {report['cli']['inference']['steady_steps_per_second']:.3f}"
        f" steps/s against phase 7's fused-tail window {fused_tail_rate:.3f} steps/s")
    print(json.dumps({"training": report["training"]}))
    print(json.dumps({"cli": report["cli"]}))
    print(json.dumps({"options": report["options"]}))
    print(json.dumps({"modes": report["modes"]}))
    print(json.dumps({"ace": report["ace"]}))
    print(json.dumps({"unet": report["unet"]}))
    print(json.dumps({"parallel": report["parallel"]}))
    print(json.dumps({"spatial": report["spatial"]}))
    print(json.dumps({"data": report["data"]}))
    print(json.dumps({"writers": report["writers"]}))
    print(json.dumps({"parity": report["parity"]}))
    print(json.dumps({"studies": report["studies"]}))
    print(json.dumps({"float16": report["float16"]}))
    print(json.dumps({"rollout_10yr": report["rollout_10yr"]}))
    print(json.dumps({"mesh_paper_window": report["mesh_paper_window"]}))
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
