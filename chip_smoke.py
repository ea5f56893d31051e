"""On-card smoke run of the PyTorch/CUDA port (``pixelnerf_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card; exits nonzero, printing no result, without one.  Phases,
one line each:

1. device: the card's name and power limit (nvidia-smi);
2. build: compile every kernel from ``pixelnerf_tpu_torch/csrc``, one
   ``nvcc`` per library, all at once: the forward and the backward at each
   hidden width (every multiple of 64 up to 512 but 448; ``-DRFC_HID``), fourteen libraries; ptxas
   registers and spills per kernel, each library's ``HGMMA`` / ``UTMALDG``
   / ``HMMA`` counts per kernel (``cuobjdump -sass``) and each weights
   kernel's shared memory; both backward kernels (the data kernel's two
   instantiations too) and both instantiations of each of the four forward
   kernels in every width's library must be wgmma + TMA kernels with no
   wmma product and no spills, and no kernel of a forward library may hold
   a wmma product; each width's forward and backward registers on lines of
   their own;
3. kernel checks: each forward kernel against its plain PyTorch version at
   the main paths' shapes (one ray chunk x 64 and x 96 samples; the
   single-view kernels on the encoded source view's 1024 x 512 table, the
   multi-view gather at NS 2 on two encoded source views, the multi-view
   dense kernel at NS 3 and at the train layout SB 4 x NS 3 x 128 rays x
   96), to ``max|d| <= 0.015 * max(1, max|ref|)`` and ``corr > 0.999``, with
   its time beside the plain version's, a cuBLAS bf16 chain's and the card's
   bound; both multi-view kernels encoded and with the deferred code at each
   of their cases, bit-identical on a second call with one launch, with
   their grid and their stream into each SM (weights, latent or table rows,
   view-sum slot); the multi-view gather also at a ragged NS 3 x 333 (gates
   only) and bit for bit the multi-view dense kernel on ``mv_latent``'s
   latent; the multi-view dense kernel also, gates only, at NS 2, at a
   ragged SB 2 x NS 3 x 333 (tiles that straddle two objects) and at NS 12
   and 24 (one view's program walked 12 and 24 times); the one-view kernels (dense and gather, encoded and deferred code)
   also at a ragged B (2000 points) and at the -V 1 train step's fine pass
   (49,152), with taps outside the table, bit-identical on a second call,
   the gather kernel bit-identical to the dense one on
   ``gather_reference``'s bf16 latent, with their TFLOP/s, share of bound
   and stream out of L2 (weights, and the gather's table rows);
   then the deferred positional code (row 6 of PERF.md) in each forward
   kernel -- its CODE variant fed the raw (xyz, viewdir) coordinates, at the
   fine pass's 393,216 points, NS 2 for the multi-view gather and NS 3 for
   the multi-view dense kernel -- against its plain version at the same bar,
   and against the same kernel fed the pre-encoded code;
4. main path: the full-width sn64 model (seeded weights, random encoder)
   renders 64x64 ring frames from one source view on the kernel route; the
   gather kernel must have launched, and frame 0 must agree with the plain
   route to >= 40 dB PSNR;
5. dense route: ``PIXELNERF_FUSED_GATHER_MAX_ROWS=0`` renders frame 0 through
   the dense kernel, which must have launched and agree with the plain route
   to >= 40 dB; frame 0 on the gather and the dense route timed in turns;
6. multi-view render: the same ring from source views (0, 1) and then
   (0, 1, 2); the first must launch the multi-view gather kernel (NS x T =
   2048 rows, within the fused-gather cap), the second the multi-view dense
   kernel (3072 rows, over it); frame 0 of each timed alone, and against the
   plain route to >= 40 dB;
7. deferred-code renders: with ``PIXELNERF_DEFER_CODE=1``, ring frame 0
   from views (0), (0, 1) and (0, 1, 2) and once on the dense route; each
   must launch the code variant of the kernel its route takes and not the
   encoded-input one, and agree with the plain route to >= 40 dB;
8. backward kernel checks at the train step's shapes (4 x 128 rays x 64 and
   x 96 samples, at -V 1 and at -V 3) and at a ragged B (2000 points at -V
   1, 666 at -V 3 and -V 10: the data kernel's last 64-point tile half full)
   and at -V 25 x 320 points (two views a split of the weights kernel),
   gates only: the kernels' stashed forward operands
   against the plain recompute (with their relu-mask flips; also whether
   the stashed t reproduces the dense forward's output at -V 1 and the
   multi-view dense forward's at -V 3 and up, i.e. that the recompute sums
   in the primal's order), every output (dz, dx, each dW and db) against
   the plain backward walked through the same operands at the bar above, and
   (up to -V 3) against the fully independent plain backward at ``corr >
   0.999``; the
   weights kernel alone against ``bwd_weights_reference`` on its own DataOut
   at the bar; two calls must be bit-identical; each kernel's time beside
   its plain version's, its yardstick (the data kernel: the autograd
   backward of the cuBLAS chain; the weights kernel: one cuBLAS bf16
   ``A^T G`` per product) and its bound, each kernel's TFLOP/s and share of
   its bound, the weights kernel's host time a call and its time at 1-24
   splits of its point axis;
9. train-step parity at -V 1 and at -V 3: one sn64 step on the kernel route
   (AMP) and one on the plain f32 route from the same weights, batch and
   draws: losses within 1%, ``grad_norm`` within 2%, cosine >= 0.99 between
   each head's and the encoder's gradients;
10. data: the port's writers write an NMR-layout fixture (``-F dvr``: 6
    objects x 24 views at 64 px, NDC cameras) and a DTU one (``-F dvr_dtu``:
    4 scans x 49 views at 300 x 400, off-centre principal points that move
    from view to view, an anisotropic focal, negated world_mats); both are
    read back through ``get_split_dataset``: every decoded pixel and mask
    must equal what the writer wrote, the poses the writer's camera ring to
    1e-5 and the DTU focal and c its intrinsics to 1e-5 relative; the host's
    ``read_png`` ms per image at both sizes, on the fixtures' files and on
    a Paeth-filtered copy (the decoder's slow path);
11. train path: ``python -m pixelnerf_tpu_torch.train`` in-process,
    ``-c conf/exp/sn64.conf -F dvr`` for 12 one-step epochs at -V 1 with
    ``--profile_dir`` and ``-c conf/exp/dtu.conf -F dvr_dtu`` for one epoch
    (32 repeats) at -V 3, both at -B 4 on 4 training objects (the SB 4 of
    the kernel checks); the forward kernel of the view count and both
    backward kernels launch twice per step, no other forward kernel
    launches, the losses stay finite and ``pixel_nerf_latest`` is written;
    the trace of the -V 1 run must hold steps 3-5 with their field kernels,
    and each step's wall time is split into the field kernels, other device
    work and the card idle, with the top device ops and the longest idle
    gaps beside the host span covering each;
12. eval path: ``python -m pixelnerf_tpu_torch.eval.eval`` in-process on a
    checkpoint of the render phases' model, on ``-F dvr`` with
    ``PIXELNERF_DEFER_CODE=1``: ``-P "0" --max_objs 2`` launches the
    single-view gather kernel's code variant, PSNR/SSIM are finite,
    ``finish.txt`` holds 2 lines and the PNGs exist; a second run resumes
    and renders nothing; one object from ``-P "0 1"`` goes through the
    multi-view gather's code variant and one from ``-P "0 1 2"`` through the
    multi-view dense kernel's; then ``-c conf/exp/dtu.conf -F dvr_dtu -P "25
    22 28" --scale 0.25`` on one scan and 4 target views, with the
    ground-truth compare, launches the multi-view dense kernel and gives
    finite PSNR/SSIM;
13. accel: the port's trainer quick-trains the full-width sn64 model on
    ``-F synthetic`` object 0 (``bench.py``'s recipe at a 1e-4 cosine peak:
    800 cosine steps and 200 polish steps at R 1024, one source view,
    random encoder; torch's deterministic algorithms on, so the run repeats
    bit for bit); its dense
    render of 16 ring frames (65,536 rays) must hold an object (foreground
    >= 0.03); ``build_accel`` builds the full grid (96^3 x 4 probe
    directions x 2 heads) through the gather kernel and sizes the
    compaction buffers; the gate walks from ``proposal`` at 30 dB and must
    settle on a rung other than dense; the settled rung and dense are
    timed in turns (rays/s, field evaluations a ray, host reads of
    ``n_live`` a frame), and the settled rung on the plain route (f32
    torch field, the same grid and draws) must agree with it to >= 40 dB;
    ``rays`` mode keeps its live rays' coarse output bit for bit the dense
    render's, its pruned rays' coarse |d| within the build's bound
    (n_coarse x eps_alpha in rgb, times z_far in depth) and its fine head
    >= 40 dB, ``samples`` >= 40 dB; a 1/64 ray capacity falls back to a
    render bit for bit the dense one; frame 0 at the settled rung launches the dense kernel under
    ``PIXELNERF_FUSED_GATHER_MAX_ROWS=0`` and the gather's code variant
    under ``PIXELNERF_DEFER_CODE=1``; then ``gen_video --accel_mode auto``
    at ``-P "0"``, ``"0 1"`` and ``"0 1 2"`` (4 frames: a gate trail, PNG
    frames, the gather, multi-view gather and multi-view dense kernel) and
    ``eval --accel proposal``
    beside ``--accel off --write_depth`` on that object, in-process on a
    checkpoint of the trained field (each target view's ``_depth.npy``
    finite, at most 1, in [0, 1] where a dense render of the same views is
    opaque, >= 0.99, and its ``_depth_norm.png`` the HOT colormap of it);
    last, the first call of every forward kernel at
    every point count those paths made (the build's chunks, the dense and
    compacted passes, the CLIs' passes) is replayed: bit for bit the
    path's own output, and against its plain version at the bar of 3;
14. multiscale: ``conf/exp/sn64_multiscale.conf`` at full width (ResNet34,
    4 stages, no first pool, the adaptive gate, attention fusion with CBAM
    to 512 at dropout 0.1, ResnetFC 512 x 5 on both heads; seeded, random
    encoder): encode ms per source view (the trunk alone, and with the gate
    and the fusion, beside sn64's) and the fused map's shape; ring frame 0
    from views (0) (the gather kernel), (0) under
    ``PIXELNERF_FUSED_GATHER_MAX_ROWS=0`` (the dense kernel), (0, 1) (the
    multi-view gather) and (0, 1, 2) (the multi-view dense kernel), each
    also with ``PIXELNERF_DEFER_CODE=1`` (its code variant), each >= 40 dB
    against the plain route and timed in turns beside sn64 on the same
    route; the raw pyramid (``use_smart_fusion = false``) on the dense
    kernel, not the gather, >= 40 dB; the train-step parity of 9 at -V 1
    and -V 3 with the fusion's dropout on (one generator seed on both
    routes, so the masks are equal), the encoder, the gate and the fusion
    each at cosine >= 0.99; ``python -m pixelnerf_tpu_torch.train -c
    conf/exp/sn64_multiscale.conf -F dvr`` on the NMR fixture for 12 steps
    at -V 1 (ms a step beside 11's sn64 step) and 3 at -V 3, rows 2 / 3, 5a
    and 5b launching twice a step (the recipe's ``vis_interval = 10`` draws
    a vis after the tenth epoch at -V 1: its launches are counted apart and
    its kernel calls replayed at the bar of 3); ``eval -P "0"`` and ``gen_video`` (4
    frames, ``--accel_mode auto``) on its checkpoint through the gather
    kernel; last, every first forward-kernel call of those renders and CLIs,
    replayed against its plain version at the bar of 3;
15. eval CLIs, in-process on the fixtures of 10, each with its wall
    seconds, rays/s, peak memory and launches on a line of its own:
    ``python -m pixelnerf_tpu_torch.eval.eval_approx`` on ``-F dvr`` (4
    objects, ``--batch_size 4``) from ``-P "0"`` and ``-P "0 1"`` with
    ``PIXELNERF_DEFER_CODE=1`` (the gather kernels' code variants; finite
    metrics, no target view among the sources); ``.eval_real`` at
    ``conf/exp/srn.conf``'s width (first pool on) on a 300 x 400 RGBA
    ``*_normalize.png`` (the DTU fixture's first view), shrunk to 256 x 341
    by the Pillow-style resize (``--size 256``), a 64 x 86 x 512 map: a
    5504-row table over the fused-gather cap, so the dense kernel's code
    variant, 24 frames of 128 x 128 with ``--accel_mode off`` and ``auto``
    on the render phases'
    weights with each head's density shifted to leave 1/32 of frame 0's
    points occupied (the grid must be kept and the gate run); ``eval -c
    conf/exp/dtu.conf -F dvr_dtu -P "25 22 28" --scale 1`` on one scan's 4
    target views of 300 x 400 (the multi-view dense kernel; finite metrics
    and the journal of 12's quarter-size run); ``eval -F dvr --multicat
    --write_depth`` on one NMR object (23 ``_depth.npy`` and
    ``_depth_norm.png``, the PNG the HOT colormap of the ``.npy``, depth at
    most 1); ``.calc_metrics`` over both eval outputs with seeded LPIPS
    weights in the ``lpips`` package's layout (map and reduce, finite
    metrics), and LPIPS's ms a batch of 32 at 64 x 64 and a 300 x 400
    pair; after each CLI, its first forward-kernel call at each point count
    replayed against its plain version at the bar of 3;
16. options: the route rule's Python mirrors of the kernels' limits against
    what the libraries report; the fork's remaining model options built in
    code from ``conf/exp/sn64.conf`` (seeded, random encoders): the global
    encoder (ResNet34 of 5 stages, its 128-wide code before the 512-wide
    pixel latent: C = 640) renders ring frame 0 from view 0 on the dense
    kernel and from views (0, 1, 2) on the multi-view dense kernel, each
    also with ``PIXELNERF_DEFER_CODE=1`` on its code variant; the ConvEncoder
    (C = 128, a 4096-row map) and the nearest lookup from view 0 on the
    dense kernel; ImplicitNet heads (5 x 512) on the plain route with no
    launch, a d_hidden 256 tower on the dense kernel (its 256-wide library,
    under ``PIXELNERF_FUSED_GATHER_MAX_ROWS=0``), and a d_hidden 1040 tower
    (past the widest library) refused under ``impl='cuda'``; every render >= 40 dB against
    the plain route and its kernel calls replayed against their plain
    versions at the bar of 3; the dense and multi-view dense kernels and
    their code variants at C = 640 (393,216 output points from 1 and 3
    views) against their plain versions, timed in turns beside C = 512, with
    their plain, cuBLAS and bound times; the backward kernels (rows 5a / 5b)
    at C = 128, 640 and 1024 from 1 and 3 views, at a ragged B and at the
    train step's fine pass (4 x 12,288 points), against their plain
    versions, bit-identical second calls, and timed at the train
    step's fine pass in turns beside C = 512 (-V 1: 640 and 128; -V 3: 640)
    with their plain, library and bound times; three train CLI steps each
    (``OPT_TRAIN``) with the global encoder at ``-V 1`` on the NMR fixture
    and ``-V 3`` on the DTU one, and with the ConvEncoder at ``-V 1``: remat
    off, the forward kernel and both backward kernels twice a step, finite
    losses, the encoder trained, ms a step; and each of those three
    configurations' train step on the kernel route against the plain f32
    step at the guards of 9 (cosine per head and per encoder, the global
    encoder included; weights where both heads' sigma is live, and no
    module with a zero gradient on both routes);
17. narrow: ``conf/exp/sn64.conf`` with both heads' d_hidden 384, then 256,
    then 128, then 64, then 320 and 192, then 200 (each its own library:
    at 384 a warpgroup's 192 columns in three m64n64k16 pieces; at 64 its
    32 columns on wgmma m64n32k16 from 64 x 32 weight boxes; at 192 its 96
    in one m64n96k16 piece on three such boxes; at 320 its 160 in two
    m64n80k16 pieces on 64 x 16 boxes; but 200 on the 256 library, its
    weights zero-padded), built in code
    (seeded as 16 seeds, random encoder): ring frame 0 from
    views (0) (the fused gather), (0) under
    ``PIXELNERF_FUSED_GATHER_MAX_ROWS=0`` (the dense kernel), (0, 1) (the
    multi-view gather) and (0, 1, 2) (the multi-view dense kernel), each
    also with ``PIXELNERF_DEFER_CODE=1`` (its CODE twin), each launching
    its kernel from the width's library and >= 40 dB against the plain f32
    route on the same draws -- or, where the kernels' plain versions (bf16
    operands, "bf16 alone") on the same weights themselves read below 40
    dB against it, >= 40 dB against that bf16-alone frame and no more than
    FRAME_ALONE_SLACK_DB below bf16 alone's reading (``frame_gate``) --
    every frame showing the object (each head's
    density shaped on each view set's scene, ``show_object``: 1/4 of frame
    0's points occupied, or more until the plain route's frame shows it),
    its kernel calls replayed against their plain versions, then timed in
    turns beside sn64's d_hidden 512 model (rays/s; at 320, 192 and 200 the
    encoded code's four routes);
    every forward kernel and twin at the fine pass (4096 rays x 96 = 393,216
    output points; NS 2 for the multi-view gather, NS 3 for the multi-view
    dense kernel) and at a ragged B (2000; NS 3 x 333; SB 2 x NS 3 x 333)
    against its plain version at the bar of 3, one launch, bit-identical
    second calls, the gathers bit for bit the dense kernels on their bf16
    latent (``forward_check``), and at the fine pass timed in turns beside
    d_hidden 512 on the same inputs (at 320 and 192 also beside the same
    tower zero-padded onto the next library: 384, 256) with its plain,
    cuBLAS and bound times;
    ``python -m
    pixelnerf_tpu_torch.eval.eval -F dvr -P "0"`` and ``-P "0 1 2"`` at
    d_hidden 256 with ``PIXELNERF_DEFER_CODE=1`` on the NMR fixture (a conf
    file including sn64's, a checkpoint of the phase's weights), launching
    the gather's and the multi-view dense kernel's CODE twins; then its
    wide part (``wide_phase``): the same frames, kernel checks and times at
    d_hidden 1024 (the forward's 1024 library: a 64-point tile on a
    cluster of two CTAs) and 640 (zero-padded onto it: the encoded routes'
    frames, the fine pass, also timed beside its own unpadded plain
    version), ``eval -P "0"`` at 1024 on the fused
    gather, and one ``-V 1`` train CLI step at 1024 on the plain field (no
    backward library past 512: no ``resnetfc_bwd_*`` launch);
18. narrow and deep backward: rows 5a / 5b at d_hidden 384, 256, 128, 64,
    320, 192 and 200 (sn64's tower, C = 512, seeded) from 1 and 3 views at
    a ragged B (SB 2 x 1000, SB 2 x NS 3 x 333) and at the train step's
    fine pass (SB 4 x 12,288 from 1 and 3 views; 200, on the 256 library,
    at the ragged B only), and at d_hidden 128 and 384 also at C = 640 and
    128 on the ragged shapes, each against its plain version as 16 gates
    the wide latents (``backward_gate``); sn64's widths at 8, 16 and 32
    blocks (``resnetfc_vjp.GRAD_MAX_BLOCKS``, the deepest the route rule
    trains on the kernels) on a 144-wide code at the ragged shapes (8: the
    fine pass too), each gate also handed four planted faults as the
    kernels' output (``planted_faults``: block 4's fc_1 product dropped,
    dx past column 128 zeroed, two blocks' dW swapped, and a stash
    recomputed without that fc_1 with the gradients walked back through
    it), each of which it must fail; 8 blocks at each width with a library of its own; kin 144
    and 512 (d_in 144 and 510) at sn64's depth on every shape; both kernels
    at the fine pass from 1 and 3 views timed in turns beside d_hidden 512
    on the same inputs (512, 384, ..., 200, 320 padded onto 384, 192 onto
    256, then back), the 8-, 16- and 32-block towers and kin 144 and 512
    beside sn64's 5 blocks and kin 48 on the same points (and the data
    kernel with dx asked beside kin 48's), with their plain, library and
    bound times, and the weights kernel on its SM-filled splits and the
    whole-view splits in turns (filled, whole, whole, filled, twice);
    ``python -m pixelnerf_tpu_torch.train`` with both heads at d_hidden
    384, then 256, then 64 (a conf file including sn64's) for 3 steps each,
    with both heads at 8 blocks and with a 138-wide code (11 frequencies
    over xyz and the view direction: kin 144) for 2 steps, at -V 1 on the
    NMR fixture and at -V 3 on the DTU one, at 320 and 200 for 2 at -V 1
    and at 192 for 2 at -V 3: remat off, the forward kernel and both
    backward kernels twice a step; the 8-block tower and the 138-wide code
    at -V 1 for 5 steps on the kernels beside the same conf on the plain
    field (``--mlp_impl torch``, the route the parent took for them) in
    turns (ms a step); each width's train step at -V 1 against the plain
    f32 step (the guards of 9; 320's at -V 3 too), and the 8- and 32-block
    towers' (32: on the batches of 4 ray seeds) and the 138-wide code's at
    -V 1 and -V 3 against it where the
    plain step under AMP meets the guards itself, else within
    ``PARITY_MARGIN`` of its readings (``step_parity``'s ``plain_amp``); and
    d_hidden 576 and 1024 towers, past the widest backward library (512;
    both keep the forward's 1024 library), a 520-wide code,
    49- and 62-block towers, past the depth these gates hold, and a d_hidden
    64 tower with four 4096-wide injections at 45 blocks, past the data
    kernel's program, under grad, plain under ``auto`` and refused under
    ``impl='cuda'``;
19. visuals: ``python -m pixelnerf_tpu_torch.train --fixed_test`` with a
    conf file that includes a shipped one and sets ``train { vis_interval =
    1 }``: ``conf/exp/sn64.conf`` on the NMR fixture at -V 1 for 2 epochs,
    ``conf/exp/dtu.conf`` on the DTU one at -V 3 for 1 epoch (32 steps; a
    full 300 x 400 target), and the first again with
    ``PIXELNERF_DEFER_CODE=1``; each ``<epoch>_vis.png`` must exist and
    ``read_png`` give back the ``vis_step`` grid bit for bit, a (2 H, 5 W,
    3) uint8 grid; each vis render must launch its row's kernel and no other
    forward kernel (the fused gather at sn64: a 1024-row table; the dense
    forward at DTU, past the 2048-row cap; the gather's CODE twin under the
    deferred code), the last vis's fine rgb must agree with the plain f32
    route on the same weights and draws to >= 40 dB, and the vis renders'
    kernel calls, replayed, must meet the bar of 3; with ``tensorboardX``
    importable an event file must exist under ``--logs_path`` (else the
    line says so); each vis render's ms and rays/s; then
    ``DiagnosticTool`` on the sn64 net with the run's weights
    (``check_model_output`` must hold and launch the fused gather), and
    ``warp_image`` of a 300 x 400 DTU view timed;
20. multi-device (``multichip_phase``; the libraries of 2 are built before
    any rank starts, and the ranks load them): ``entry.dryrun_multichip(4,
    "cuda")``, four ranks sharing card 0 over gloo on a data 2 x rays 2
    mesh, sn64 at full width on the kernel route, torch's deterministic
    algorithms on: step 1 against one process at the JAX dry run's bars,
    the resumed run bit for bit the unbroken one, its step 2 against one
    process resuming the same checkpoint at step 1's bars, the eval leg at
    the JAX bars (step 2 against two unsharded steps, the per-module
    gradient norms and the share of weights more than lr/2 apart
    printed); then one launch of two ranks on card 0 (``--gpu_id "0 0"``)
    that checks that gloo takes CUDA tensors as they are for each
    collective of ``parallel.launch`` and gives the right values, times the port's
    gradient mean and one BatchNorm statistic's sum, and runs ``python -m
    pixelnerf_tpu_torch.train`` (sn64 on the NMR fixture, -B 4, -V 1, 3
    epochs of one step, ``vis_interval = 2``: rank 0's vis between steps;
    at ``--lr`` 1e-4 and 1e-6), ``eval -P "0"`` and ``gen_video`` on a
    field with 1/32 of its points occupied (the accel kept, its gate run)
    with ``PIXELNERF_DEFER_CODE=1`` in the ranks, each against the same CLI
    on one rank in this process: step 1 within rel 1e-4 (loss) and 1e-3
    (``grad_norm``), every step's loss within 1e-3 (later steps'
    ``grad_norm`` printed: Adam's first updates carry the ranks' bf16
    rounding), PSNR within 1e-3 dB and SSIM within 1e-4, each PNG and video
    frame within one u8 level, the same accel rung; every rank must launch
    each kernel of its path (the dense forward and both backward kernels in
    training, the fused gather in eval, its CODE twin in the video), and
    every kernel call a rank made is replayed against its plain version at
    the bar of 3 (``ops.replay``); each leg's wall seconds and peak memory
    per rank, the step ms at 1 and 2 ranks; last the root smoke tools'
    twins (``tools.training_smoke`` on sn64, ``tools.memory_smoke`` on the
    NMR fixture, ``tools.check_config``) once each;
21. ResNet50 (``resnet50_phase``): rows 1-4 and their CODE twins at
    ResNet50's latent widths, C = 832, 1856 and 3904 (3, 4 and 5 encoder
    layers: 2, 4 and 8 pieces of 512 columns an injection, the last one 320
    wide), on sn64's tower (d_hidden 512) with seeded (3, 1024, C) tables,
    at a ragged B (the gathers from 1, 2 and 3 views, the dense kernels from
    1 view and SB 2 x NS 3 x 333) against their plain versions at the bar
    of 3, one launch, bit-identical second calls and the gathers bit for bit
    the dense kernels on their bf16 latent; at 1856 and 3904 also at the
    fine pass (393,216 output points, NS 2 for the multi-view gather, NS 3
    for the multi-view dense kernel: 131,072 output points at 3904) timed in
    turns beside C = 512 with their plain, cuBLAS and bound times; rows 5a /
    5b at each width from 1 and 3 views through ``backward_gate`` (ragged,
    and the train step's fine pass at 1856), both timed at the fine pass
    at 1856 and 3904 beside C = 512 in turns (512, 1856, 3904, 3904, 1856,
    512) with their plain, library and bound times; the narrower libraries
    at a ResNet50 width (d_hidden 384 and 256 at 1856, 128 and 64 at 3904:
    61 dz steps an injection) on the ragged shapes, forward and backward;
    then ``conf/exp/sn64.conf`` with ``model.encoder.backbone = resnet50``
    (4 layers, no first pool: a 32 x 32 x 1856 map; seeded, random encoder)
    renders ring frame 0 from views (0) (the fused gather), (0) under
    ``PIXELNERF_FUSED_GATHER_MAX_ROWS=0`` (the dense kernel), (0, 1) (the
    multi-view gather) and (0, 1, 2) (the multi-view dense kernel), each
    also with ``PIXELNERF_DEFER_CODE=1``, each launching its kernel and >=
    40 dB against the plain f32 route, its kernel calls replayed against
    their plain versions, the encoded routes timed in turns beside sn64's
    ResNet34 model; ResNet50 at 3 layers (C = 832) and ResNet34 at 5 (C =
    1024) render frame 0 from view 0 on the fused gather (the route that
    raised before the gathers took pieces), >= 40 dB, each frame showing
    the object (the density shaped on the view's scene, ``show_object``);
    ``eval -P "0"`` on the
    NMR fixture through the fused gather; ``python -m
    pixelnerf_tpu_torch.train`` with ResNet50 (a conf file including
    sn64's) for 3 steps at -V 1 on the NMR fixture and at -V 3 on the DTU
    one, remat off, the forward kernel and both backward kernels twice a
    step; and the train step from 1 and 3 views against the plain f32 step
    at the guards of 9.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import glob
import itertools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from typing import Optional

import torch

# H100 SXM peaks (data sheet, dense): bf16 tensor-core rate and HBM3 rate
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
FRAME = 64
N_FRAMES = 3
RAYS_PER_STEP = FRAME * FRAME  # one frame per render step: frame 0 is step 0
SEED = 0
# the data phase's fixtures: the NMR layout of conf/exp/sn64.conf and DTU's
# own image size, views per scan and camera oddities (conf/exp/dtu.conf)
NMR_OBJS, NMR_VIEWS = 6, 24
DTU_SCANS, DTU_VIEWS, DTU_SIZE = 4, 49, (300, 400)
DTU_KNOBS = dict(offcenter_c=0.05, focal_aniso=1.1, negate_world_mat=True)
DTU_EVAL_VIEWS = (0, 10, 33, 45)
# the eval CLI's rays a render call: the dense multi-view route holds
# rays x 96 samples x views latents of 512 f32 (9.7 GB at 3 views)
EVAL_RAYS = 16384
# the forward kernel a train step at that view count runs
STEP_KERNEL = {1: "resnetfc_fwd_dense", 3: "resnetfc_fwd_dense_mv"}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    mse = torch.mean((a.float() - b.float()) ** 2).item()
    return float("inf") if mse == 0 else 10.0 * math.log10(1.0 / mse)


def replayed(rows, what: str, records=None, code_records=None) -> None:
    """Logs the kernel calls of ``what`` replayed against their plain
    versions (``KernelCalls.check`` rows) and exits unless each met the bar;
    with ``records``, keeps each kernel's largest |d|."""
    log(f"{what}: the kernel calls against their plain versions (max|d| <= 0.015 x "
        "max(1, max|ref|), corr > 0.999, bit for bit the path's output): " + json.dumps(
            [dict(r, max_abs_err=float(f"{r['max_abs_err']:.6g}"), bar=float(f"{r['bar']:.6g}"),
                  corr=round(r["corr"], 7)) for r in rows]))
    if not rows or not all(r["ok"] for r in rows):
        raise SystemExit(f"{what}: a kernel disagrees with its plain version")
    for r in rows if records is not None else ():
        rec = records[r["kernel"]] if r["kernel"] in records else code_records[r["kernel"]]
        rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), r["max_abs_err"])


def library_tower(z, x, tw, n_blocks):
    """The tower as a chain of cuBLAS bf16 products (bf16 in and out): the
    yardstick for ``library_ms``; the port never calls it."""
    tw = type(tw)(*(t.bfloat16() for t in tw[:8]), tw.d_in, tw.d_hidden)
    h = torch.addmm(tw.b_in, x.bfloat16(), tw.w_in[: tw.d_in])
    for k in range(n_blocks):
        if k < tw.w_z.shape[0]:
            h = h + torch.addmm(tw.b_z[k], z, tw.w_z[k])
        t = torch.addmm(tw.b_blk[k, 0], torch.relu(h), tw.w_blk[k, 0])
        h = h + torch.addmm(tw.b_blk[k, 1], torch.relu(t), tw.w_blk[k, 1])
    return torch.addmm(tw.b_out, torch.relu(h), tw.w_out).t()


def library_tower_mv(z, x, tw, n_blocks, NS, combine_layer):
    """The multi-view tower (rows 3-4 of PERF.md) as a cuBLAS bf16 chain:
    per-view rows (NS, B, .) up to ``combine_layer``, their mean, the shared
    tail: the yardstick for ``library_ms``; the port never calls it."""
    tw = type(tw)(*(t.bfloat16() for t in tw[:8]), tw.d_in, tw.d_hidden)
    h = torch.matmul(x.bfloat16(), tw.w_in[: tw.d_in]) + tw.b_in
    for k in range(n_blocks):
        if k == combine_layer:
            h = h.mean(0)
        if k < combine_layer:
            h = h + (torch.matmul(z, tw.w_z[k]) + tw.b_z[k])
        t = torch.matmul(torch.relu(h), tw.w_blk[k, 0]) + tw.b_blk[k, 0]
        h = h + (torch.matmul(torch.relu(t), tw.w_blk[k, 1]) + tw.b_blk[k, 1])
    return (torch.matmul(torch.relu(h), tw.w_out) + tw.b_out).t()


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()  # f32 sums over ~1e7 elements read past 1
    return (torch.dot(a, b) / (a.norm() * b.norm() + 1e-30)).item()


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# template arguments of the kernels, for naming ptxas' entry functions
TEMPLATE_ARGS = {"resnetfc_fwd_gather_mv_kernel": ("CODE",),
                 "resnetfc_fwd_dense_kernel": ("CODE",),
                 "resnetfc_fwd_gather_kernel": ("CODE",),
                 "resnetfc_fwd_dense_mv_kernel": ("CODE",),
                 "resnetfc_bwd_data_kernel": ("MV",)}


def kernel_name(mangled: str) -> str:
    """kernel<args> from a mangled entry name (the anonymous namespace's
    mangled name holds the file name too)."""
    k = re.search(r"\d(resnetfc_[a-z_]+_kernel)(I(?:Lb[01]E)+E)?", mangled)
    base = k.group(1) if k else mangled
    bools = re.findall(r"Lb([01])E", k.group(2) or "") if k else []
    args = ",".join(f"{a}={b}" for a, b in zip(TEMPLATE_ARGS.get(base, ()), bools))
    return f"{base}<{args}>" if args else base


def ptxas_summary(log: str) -> dict:
    """{kernel<args>: "N registers, S B spill stores, L B spill loads"} from
    nvcc's ``-Xptxas -v`` output, with any ptxas warning about the kernel."""
    out, name, spill = {}, None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = kernel_name(m.group(1))
        elif "warning" in ln and name and name in out:
            out[name] += f"; {ln.strip()}"
        elif "spill stores" in ln:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln and name:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            st = re.search(r"(\d+) bytes spill stores", spill)
            ld = re.search(r"(\d+) bytes spill loads", spill)
            out[name] = (f"{regs} registers, {st.group(1) if st else '?'} B spill stores, "
                         f"{ld.group(1) if ld else '?'} B spill loads")
            name, spill = None, ""
    return out


def sass_counts(library) -> dict:
    """{kernel<args>: {"HGMMA": n, "UTMALDG": n, "HMMA": n}}: the warpgroup
    products, the TMA loads and the warp-level (wmma) products in each
    kernel's SASS (``cuobjdump -sass`` beside nvcc), or {} without it."""
    from pixelnerf_tpu_torch.ops import resnetfc_fused as rf

    tool = os.path.join(os.path.dirname(rf._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    out, name = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = kernel_name(m.group(1))
            out[name] = {"HGMMA": 0, "UTMALDG": 0, "HMMA": 0}
        elif name:
            for op in out[name]:
                out[name][op] += bool(re.search(rf"\b{op}\b", ln))
    return out


def mv_latent(tables, idx, w, sb: int):
    """Dense bf16 latents of object-major rows (sb, NS, B_obj): row (s, v, b)
    is the 4-tap lookup ``idx``/``w`` (same rows) into ``tables[v]``."""
    from pixelnerf_tpu_torch.ops import resnetfc_fused as rf

    NS = tables.shape[0]
    i4, w4 = idx.reshape(sb, NS, -1, idx.shape[-1]), w.reshape(sb, NS, -1, w.shape[-1])
    z = torch.stack([
        rf.gather_reference(i4[:, v].reshape(-1, idx.shape[-1]), w4[:, v].reshape(-1, w.shape[-1]),
                            tables[v], torch.bfloat16).reshape(sb, -1, tables.shape[-1])
        for v in range(NS)], dim=1)
    return z.reshape(-1, tables.shape[-1]).to(torch.bfloat16)


def by_view(a: torch.Tensor, NS: int, sb: int) -> torch.Tensor:
    """Object-major rows (sb * NS * B_obj, D) -> (NS, sb * B_obj, D), the
    cuBLAS chain's layout."""
    return a.reshape(sb, NS, -1, a.shape[-1]).transpose(0, 1).reshape(NS, -1, a.shape[-1])


def paeth_png(img):
    """The PNG file of an (H, W, 3) uint8 image with every row Paeth-filtered
    (the port's writer writes filter 0 only)."""
    import struct
    import zlib

    import numpy as np

    H, W, C = img.shape
    x = img.reshape(H, W * C).astype(np.int16)
    a, b, c = (np.zeros_like(x) for _ in range(3))
    a[:, C:], b[1:], c[1:, C:] = x[:, :-C], x[:-1], x[:-1, :-C]  # left, up, up-left
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    rows = np.concatenate([np.full((H, 1), 4, np.uint8), ((x - pred) & 255).astype(np.uint8)], 1)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def data_phase(root: str, smi: str):
    """Write the NMR-layout and DTU fixtures with the port's writers, read
    them back through ``get_split_dataset`` and hold every decoded pixel,
    pose and intrinsic against what the writers wrote; time the PNG decode
    per image.  Returns the two fixture roots."""
    import numpy as np

    from pixelnerf_tpu_torch.data import get_split_dataset
    from pixelnerf_tpu_torch.data import synthetic as psynth
    from pixelnerf_tpu_torch.utils import png

    t0 = time.perf_counter()
    written = {}  # path -> the uint8 image the writer wrote there
    write_png = psynth.write_png

    def recording_write(path, img, *args, **kwargs):
        written[path] = np.array(img)
        write_png(path, img, *args, **kwargs)

    psynth.write_png = recording_write
    try:
        nmr = psynth.write_synthetic_dvr(os.path.join(root, "nmr"), n_objs=NMR_OBJS,
                                         n_views=NMR_VIEWS, image_size=FRAME, seed=SEED)
        t_nmr = time.perf_counter() - t0
        dtu = psynth.write_synthetic_dtu(os.path.join(root, "dtu"), n_scenes=DTU_SCANS,
                                         n_views=DTU_VIEWS, image_size=DTU_SIZE, seed=SEED,
                                         **DTU_KNOBS)
        t_write = time.perf_counter() - t0
    finally:
        psynth.write_png = write_png

    def expect_images(paths):
        return np.stack([(written[p][..., :3].astype(np.float32) / 255.0) * 2.0 - 1.0
                         for p in paths])

    worst = {"nmr_pose": 0.0, "dtu_pose": 0.0, "dtu_intrinsics": 0.0}
    n_checked, t_read = 0, {}
    # each object once: the NMR lists split the objects; every DTU split
    # falls back to, or lists, every scan
    for fmt, fx_root, splits in (("dvr", nmr, ("train", "val", "test")), ("dvr_dtu", dtu, ("val",))):
        sizes = [len(d) for d in get_split_dataset(fmt, fx_root)]
        if sizes != ([NMR_OBJS - 2, 1, 1] if fmt == "dvr" else [DTU_SCANS] * 3):
            raise SystemExit(f"data: -F {fmt} splits hold {sizes} objects")
        n_obj, t_in = 0, 0.0
        for split in splits:
            dset = get_split_dataset(fmt, fx_root, want_split=split)
            for i in range(len(dset)):
                t1 = time.perf_counter()
                s = dset[i]
                t_in += time.perf_counter() - t1
                n_obj += 1
                paths = sorted(os.path.join(s["path"], "image", f)
                               for f in os.listdir(os.path.join(s["path"], "image")))
                if not np.array_equal(s["images"], expect_images(paths)):
                    raise SystemExit(f"data: decoded pixels of {s['path']} differ from the written")
                name = os.path.basename(s["path"])
                if fmt == "dvr":
                    ring = psynth._camera_ring(NMR_VIEWS, seed=SEED * 1000 + int(name[3:]))
                    worst["nmr_pose"] = max(worst["nmr_pose"], float(np.abs(s["poses"] - ring).max()))
                    ok = (np.ndim(s["focal"]) == 0 and abs(float(s["focal"]) - 0.85 * FRAME) <= 1e-4
                          and np.allclose(s["c"], [[FRAME / 2, FRAME / 2]], rtol=1e-5))
                else:
                    si = int(name[4:]) - 1
                    ring = psynth._camera_ring(DTU_VIEWS, radius=1.6, seed=SEED * 77 + si)
                    worst["dtu_pose"] = max(worst["dtu_pose"], float(np.abs(s["poses"] - ring).max()))
                    with open(os.path.join(s["path"], "meta.json")) as f:
                        intr = np.asarray(json.load(f)["intrinsics"], np.float64)
                    focal = np.broadcast_to(np.asarray(s["focal"]).reshape(-1, 2), intr[:, :2].shape)
                    c = np.broadcast_to(np.asarray(s["c"]).reshape(-1, 2), intr[:, 2:].shape)
                    rel = max(float(np.abs(focal - intr[:, :2]).max() / np.abs(intr[:, :2]).max()),
                              float(np.abs(c - intr[:, 2:]).max() / np.abs(intr[:, 2:]).max()))
                    worst["dtu_intrinsics"] = max(worst["dtu_intrinsics"], rel)
                    masks = np.stack([written[p.replace("/image/", "/mask/")][..., :1] / 255.0
                                      for p in paths]).astype(np.float32)
                    ok = (s["images"].shape == (DTU_VIEWS,) + DTU_SIZE + (3,)
                          and np.array_equal(s["masks"], masks))
                if not ok:
                    raise SystemExit(f"data: {s['path']}: focal / c / masks differ from the written")
                n_checked += len(paths)
        t_read[fmt] = t_in / n_obj
    if max(worst["nmr_pose"], worst["dtu_pose"]) > 1e-5 or worst["dtu_intrinsics"] > 1e-5:
        raise SystemExit(f"data: poses or intrinsics off the writer's: {worst}")

    # decode ms per image: the fixtures' files (filter 0) and, at both sizes,
    # the same image with every row Paeth-filtered (the decoder's slow path)
    decode_ms = {}
    rng = np.random.default_rng(SEED)
    for label, files in (("64x64", [p for p in written if p.startswith(nmr)]),
                         ("300x400", [p for p in written if "/image/" in p and p.startswith(dtu)])):
        t1 = time.perf_counter()
        for p in files:
            png.read_png(p)
        decode_ms[f"{label} filter 0"] = 1e3 * (time.perf_counter() - t1) / len(files)
        img = written[files[0]] ^ rng.integers(0, 8, size=written[files[0]].shape, dtype=np.uint8)
        paeth = os.path.join(root, f"paeth_{label}.png")
        with open(paeth, "wb") as f:
            f.write(paeth_png(img))
        t1 = time.perf_counter()
        for _ in range(3):
            back = png.read_png(paeth)
        decode_ms[f"{label} Paeth"] = 1e3 * (time.perf_counter() - t1) / 3
        if not np.array_equal(back, img):
            raise SystemExit(f"data: a Paeth-filtered {label} file does not decode to its pixels")
    log(f"data: port writers -> {NMR_OBJS} NMR objects x {NMR_VIEWS} views at {FRAME}px "
        f"(-F dvr) and {DTU_SCANS} DTU scans x {DTU_VIEWS} views at {DTU_SIZE[0]}x{DTU_SIZE[1]} "
        f"(-F dvr_dtu, {DTU_KNOBS}) in {t_write:.3f} s ({t_nmr:.3f} s NMR); read back through "
        f"get_split_dataset: {n_checked} images equal to the written pixels, masks equal, worst "
        f"pose error {json.dumps({k: float(f'{v:.3g}') for k, v in worst.items()})} (<= 1e-5); "
        f"adapter ms per object {json.dumps({k: round(1e3 * v, 3) for k, v in t_read.items()})}")
    log(f"data: read_png ms per image (host of {smi}) "
        f"{json.dumps({k: round(v, 3) for k, v in decode_ms.items()})}")
    return nmr, dtu


def profile_split(path: str, smi: str, step_kernel: str, label: str = "profile") -> None:
    """Gate and print the -V 1 train run's trace: each of steps 3-5 holds the
    step's field kernels (2 launches each), and its wall time splits into
    the field kernels, other device work and the card idle.  Each line
    starts with ``label``."""
    from pixelnerf_tpu_torch.train.profile import split_trace

    sp = split_trace(path)
    want = {step_kernel: 2, "resnetfc_bwd_data": 2, "resnetfc_bwd_weights": 2}
    steps = sp["steps"]
    if sorted(steps) != [3, 4, 5] or any(
            {k: st["field_launches"].get(k, 0) for k in want} != want for st in steps.values()):
        raise SystemExit(f"{label}: trace {path} lacks steps 3-5 or their field kernels: "
                         f"{ {n: st['field_launches'] for n, st in steps.items()} }")
    mean = {k: sum(st[k] for st in steps.values()) / 3
            for k in ("wall_ms", "field_ms", "other_ms", "idle_ms")}
    log(f"{label}: -V 1 train steps 3-5 from the trace, ms "
        + json.dumps({n: {k: round(st[k], 3) for k in ("wall_ms", "field_ms", "other_ms", "idle_ms")}
                      for n, st in steps.items()})
        + f"; mean wall {mean['wall_ms']:.3f} = field kernels {mean['field_ms']:.3f} "
        f"({mean['field_ms'] / mean['wall_ms']:.3f}) + other device work {mean['other_ms']:.3f} "
        f"({mean['other_ms'] / mean['wall_ms']:.3f}) + card idle {mean['idle_ms']:.3f} "
        f"({mean['idle_ms'] / mean['wall_ms']:.3f}); on {smi}")
    phases = {}
    for st in steps.values():
        for name, ph in st.get("phases", {}).items():
            acc = phases.setdefault(name, {"wall_ms": 0.0, "busy_ms": 0.0, "idle_ms": 0.0})
            for k in acc:
                acc[k] += ph[k] / 3
    log(f"{label}: the mean traced step by host phase (forward to the first backward node, the "
        "autograd nodes, Optimizer.step, the rest), ms "
        + (json.dumps({k: {kk: round(vv, 3) for kk, vv in v.items()} for k, v in phases.items()})
           if phases else "not in the trace (no autograd nodes recorded)"))
    log(f"{label}: top device ops over steps 3-5 (name, ms, launches) "
        + json.dumps([(n[:90], round(ms, 3), c) for n, ms, c in sp["top_ops"]]))
    log(f"{label}: longest idle gaps (ms, step, innermost host span covering half of it) "
        + json.dumps([(round(ms, 3), n, h) for ms, n, h in sp["gaps"]]))


# step_parity's "plain_amp" yardstick: where the plain step under AMP itself
# misses a guard against the plain f32 step, the kernel route's reading may
# be this many times the plain AMP step's (PERF.md section 6)
PARITY_MARGIN = 2.0
# the ray seeds of the batches on which the deepest routed tower's train
# step is held, batch by batch (seeds 4-7 set its depth with
# scripts/torch_deep_checks.py: PERF.md section 6)
PARITY_SEEDS = (0, 1, 2, 3)
# step_parity's routes: (mlp_impl, AMP)
PARITY_ROUTES = {"kernel": ("auto", True), "plain": ("torch", False), "plain_amp": ("torch", True)}


def step_parity(conf, state, nviews: int, dev, label: str, note: str = "", seed: int = SEED,
                yardstick: str = "plain", check: bool = True) -> dict:
    """One train step on the kernel route (AMP) and one on the plain f32
    route, both from ``state``, on one ``prepare_ray_batch`` batch of -F
    synthetic (B 4, V ``nviews``, R 128; rays drawn from ``seed``) with
    shared draws and one generator seed (so the same dropout masks): the
    guards of PERF.md section 2 (loss within 1%, ``grad_norm`` within 2%,
    gradient cosine >= 0.99 for each top-level module: each head and each
    encoder) against the ``yardstick`` route, the kernel route launching its
    forward kernel (the dense one at one view, the multi-view one past it),
    ``resnetfc_bwd_data`` and ``resnetfc_bwd_weights`` twice each and
    nothing else, the other routes nothing.  The yardstick is the plain f32
    step, or ``plain_amp``: the plain step under AMP is run too, and each
    guard against the plain f32 step holds where the plain AMP step meets it
    itself, and where it does not, the kernel route's reading stays within
    PARITY_MARGIN times the plain AMP step's (1 - cosine for a cosine; both
    logged, so that what bf16 alone does on this batch shows).  A module
    whose gradient is
    exactly zero on both routes (a head that no sample reaches: every sigma
    at or below zero) fails: its kernels would be compared on nothing.  Logs
    one line; with ``check``, exits on a failure.  Returns the kernel
    route's launches, ``ok`` and each route's distance from the others."""
    import numpy as np

    from pixelnerf_tpu_torch.data import collate, get_split_dataset
    from pixelnerf_tpu_torch.models.losses import l2_loss
    from pixelnerf_tpu_torch.models.pixelnerf import make_model
    from pixelnerf_tpu_torch.ops import resnetfc_fused as rf
    from pixelnerf_tpu_torch.ops import resnetfc_vjp as rv
    from pixelnerf_tpu_torch.render.renderer import NeRFRenderer, RayDraws
    from pixelnerf_tpu_torch.train import Optimizer, make_step_fns, prepare_ray_batch

    ds = get_split_dataset("synthetic", "", want_split="train")
    rcfg = NeRFRenderer.from_conf(conf["renderer"], lindisp=ds.lindisp).cfg
    n_rays, n_imp = 4 * 128, rcfg.n_fine - rcfg.n_fine_depth
    batch_np = prepare_ray_batch(collate([ds[i] for i in range(len(ds))]), nviews, 128,
                                 ds.z_near, ds.z_far, True, np.random.default_rng(seed))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
    gd = torch.Generator(device=dev).manual_seed(seed + 3)
    draws = RayDraws(
        coarse=torch.rand(n_rays, rcfg.n_coarse, device=dev, generator=gd),
        fine_u=torch.rand(n_rays, n_imp, device=dev, generator=gd),
        fine_jitter=torch.rand(n_rays, n_imp, device=dev, generator=gd),
        depth=torch.randn(n_rays, rcfg.n_fine_depth, device=dev, generator=gd))
    routes = ("kernel", "plain") + (("plain_amp",) if yardstick == "plain_amp" else ())
    steps = {}
    for route in routes:
        impl, amp = PARITY_ROUTES[route]
        tnet = make_model(conf["model"], mlp_impl=impl, device=dev, diff_mode=True)
        tnet.load_state_dict(state)
        opt = Optimizer(list(tnet.parameters()), lambda t: 1e-4)
        train_step, _ = make_step_fns(tnet, opt, lambda: rcfg, 1.0, 1.0, l2_loss, l2_loss,
                                      tnet.use_viewdirs, amp=amp,
                                      remat=not tnet.field_backward_in_kernel(nviews))
        rf.reset_launches()
        rv.reset_launches()
        ld = {k: float(v) for k, v in train_step(
            batch, torch.Generator(device=dev).manual_seed(seed + 5), draws).items()}
        torch.cuda.synchronize()
        groups = {}
        for n, prm in tnet.named_parameters():
            groups.setdefault(n.split(".")[0], []).append(prm.grad.detach().float().flatten())
        steps[route] = (ld, {k: torch.cat(v) for k, v in groups.items()},
                        {k: v for k, v in dict(rf.LAUNCHES, **rv.LAUNCHES).items() if v})
        del tnet, opt

    def gaps(a, b):
        (la, ga, _), (lb, gb, _) = steps[a], steps[b]
        return {"loss": abs(la["t"] - lb["t"]) / abs(lb["t"]),
                "grad_norm": abs(la["grad_norm"] - lb["grad_norm"]) / lb["grad_norm"],
                "cosine": {k: cosine(ga[k], gb[k]) for k in gb}}

    (lk, gk, nk), (ly, gy, _) = steps["kernel"], steps["plain"]
    k32 = gaps("kernel", "plain")
    a32 = gaps("plain_amp", "plain") if yardstick == "plain_amp" else None
    dead = sorted(k for k in gy if not gk[k].any() and not gy[k].any())
    fwd = STEP_KERNEL[nviews]
    others = {r: steps[r][2] for r in routes if r != "kernel"}
    sound = (not dead and nk == {fwd: 2, "resnetfc_bwd_data": 2, "resnetfc_bwd_weights": 2}
             and not any(others.values()))
    ok = sound and held_to_amp(k32, a32)
    norms = {k: [float(f"{steps[r][1][k].norm().item():.6g}") for r in routes] for k in gy}
    extra = ""
    if a32 is not None:
        def fmt(v):
            return (f"loss {v['loss']:.3g}, grad_norm {v['grad_norm']:.3g}, cosine "
                    f"{json.dumps({k: round(c, 6) for k, c in v['cosine'].items()})}")
        extra = (f"; the plain route under AMP from the plain f32 step (where it misses a guard, "
                 f"the kernel route may read {PARITY_MARGIN} x it) {fmt(a32)}; the kernel route "
                 f"from the plain route under AMP {fmt(gaps('kernel', 'plain_amp'))}")
    log(f"{label + ' ' if label else ''}train-step parity -V {nviews}{note}"
        f"{f' (rays of seed {seed})' if seed != SEED else ''}, against the plain f32 route: "
        f"loss kernel {lk['t']:.6f} plain {ly['t']:.6f} (rel {k32['loss']:.3g} <= 0.01); "
        f"grad_norm {lk['grad_norm']:.6f} vs {ly['grad_norm']:.6f} (rel {k32['grad_norm']:.3g} "
        f"<= 0.02); gradient cosine {json.dumps({k: round(v, 6) for k, v in k32['cosine'].items()})}"
        f" (>= 0.99); zero on both routes (must be none): {dead}; gradient norms {list(routes)} "
        f"{json.dumps(norms)}; kernel-route launches {nk}; the other routes' launches "
        f"{others}" + extra + f"; passed {ok}")
    if check and not ok:
        raise SystemExit(f"{label + ' ' if label else ''}train-step parity failed at -V {nviews}")
    return {"launches": nk, "ok": ok,
            "gaps": {f"{a}~{b}": gaps(a, b) for i, a in enumerate(routes) for b in routes[i + 1:]},
            "grad_norm": {r: steps[r][0]["grad_norm"] for r in routes}}


def held_to_amp(kernel: dict, amp: Optional[dict]) -> bool:
    """PERF.md section 2's guards on the kernel route's distances from the
    plain f32 step (``gaps``: loss, grad_norm, each module's cosine) where
    the plain step under AMP (its distances ``amp``; None: every guard)
    meets them itself, else PARITY_MARGIN times the AMP step's distance (1 -
    cosine for a cosine)."""

    def held(k, a, guard):
        return k <= guard if a is None or a <= guard else k <= PARITY_MARGIN * a

    return (held(kernel["loss"], amp and amp["loss"], 0.01)
            and held(kernel["grad_norm"], amp and amp["grad_norm"], 0.02)
            and all(held(1 - kernel["cosine"][m], amp and 1 - amp["cosine"][m], 0.01)
                    for m in kernel["cosine"]))


def train_eval_paths(nmr_root, dtu_root, net, smi, records, code_records, bwd_ms,
                     weights_ms_at, fwd_ms, n_rays) -> dict:
    """Phases 10-11: the train CLI on -F dvr (-V 1, traced) and -F dvr_dtu
    (-V 3), then the eval CLI on -F dvr (1, 2 and 3 source views, deferred
    code) and on -F dvr_dtu (3 views, --scale 0.25, ground-truth compare).
    Returns the train CLI's ms a step, by view count."""
    import types

    from pixelnerf_tpu_torch.eval.eval import main as eval_main
    from pixelnerf_tpu_torch.ops import resnetfc_fused as rf
    from pixelnerf_tpu_torch.ops import resnetfc_vjp as rv
    from pixelnerf_tpu_torch.train import checkpoints
    from pixelnerf_tpu_torch.train import main as train_main

    # ---- train path: the train CLI in-process on the file formats ----
    step_ms_at = {}
    for nviews, conf_path, fmt, root, epochs in ((1, "conf/exp/sn64.conf", "dvr", nmr_root, 12),
                                                 (3, "conf/exp/dtu.conf", "dvr_dtu", dtu_root, 1)):
        fwd = STEP_KERNEL[nviews]
        os.environ["PIXELNERF_ALLOW_RANDOM_BACKBONE"] = "1"  # no backbone weights on this machine
        try:
            with tempfile.TemporaryDirectory() as ck:
                prof = os.path.join(ck, "profile")
                argv = ["-n", "chip_smoke", "-c", conf_path, "-F", fmt, "-D", root, "-B", "4",
                        "-V", str(nviews), "-R", "128", "--epochs", str(epochs),
                        "--checkpoints_path", ck] + (["--profile_dir", prof] if nviews == 1 else [])
                torch.cuda.synchronize()
                rf.reset_launches()
                rv.reset_launches()
                t0 = time.perf_counter()
                trainer = train_main(argv)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                train_launches = dict(rf.LAUNCHES, **rv.LAUNCHES)
                wrote = os.path.exists(os.path.join(ck, "chip_smoke", "pixel_nerf_latest"))
                if nviews == 1:
                    profile_split(os.path.join(prof, "trace.json"), smi, fwd)
        finally:
            del os.environ["PIXELNERF_ALLOW_RANDOM_BACKBONE"]
        n_steps, n_val = trainer.global_step, len(trainer.test_loader)
        want_steps = epochs * trainer.num_epoch_repeats * len(trainer.train_loader)
        finite = len(trainer.history) == n_steps and all(math.isfinite(v) for v in trainer.history)
        first = 5 if nviews == 1 else 2  # after the traced steps 3-5 at -V 1
        step_ms = 1e3 * sum(trainer.step_seconds[first:]) / max(1, len(trainer.step_seconds[first:]))
        traced_ms = 1e3 * sum(trainer.step_seconds[2:5]) / 3
        step_ms_at[nviews] = step_ms
        k_bwd = bwd_ms[(nviews, 64)] + bwd_ms[(nviews, 96)]
        k_w = weights_ms_at[(nviews, 64)] + weights_ms_at[(nviews, 96)]
        k_fwd = fwd_ms[(nviews, 64)] + fwd_ms[(nviews, 96)]
        images = trainer.train_loader.dataset[0]["images"].shape
        log(f"train path: python -m pixelnerf_tpu_torch.train -c {conf_path} -F {fmt} -B 4 -V "
            f"{nviews} -R 128 --epochs {epochs}{' --profile_dir' if nviews == 1 else ''} (random "
            f"encoder; {len(trainer.train_loader.dataset)} training objects of {images[0]} views "
            f"at {images[1]}x{images[2]}): {n_steps} steps in {wall:.3f} s, remat {trainer.remat}, "
            f"launches {train_launches} ({n_val} validation batch(es) add 2 {fwd} launches each); "
            f"losses {[round(v, 5) for v in trainer.history]} finite {finite}; "
            f"pixel_nerf_latest written {wrote}")
        log(f"train path -V {nviews} on -F {fmt}: {step_ms:.3f} ms per step over steps "
            f"{first + 1}-{n_steps} = {n_rays / step_ms * 1e3:.1f} rays/s"
            + (f" (steps 3-5, traced: {traced_ms:.3f} ms)" if nviews == 1 else "")
            + f"; backward kernels {k_bwd:.3f} ms per step = {k_bwd / step_ms:.3f} of it "
            f"(resnetfc_bwd_weights {k_w:.3f} ms = {k_w / step_ms:.3f}), forward kernels "
            f"{k_fwd:.3f} ms = {k_fwd / step_ms:.3f}; on {smi}")
        if not (n_steps == want_steps and finite and wrote and not trainer.remat
                and len(trainer.train_loader.dataset) == 4  # SB 4, the checks' shape
                and train_launches[fwd] == 2 * n_steps + 2 * n_val
                and train_launches["resnetfc_bwd_data"] == 2 * n_steps
                and train_launches["resnetfc_bwd_weights"] == 2 * n_steps
                and not any(v for k, v in train_launches.items()
                            if k.startswith("resnetfc_fwd") and k != fwd)):
            raise SystemExit(f"train path at -V {nviews} on -F {fmt} failed or did not run "
                             "through the kernels")
        for name in ("resnetfc_bwd_data", "resnetfc_bwd_weights"):
            if nviews == 1:
                records[name]["launches"] = train_launches[name]
            else:
                records[name][f"ns{nviews}"]["launches"] = train_launches[name]

    # ---- eval path: the eval CLI in-process on the file formats ----
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ck")
        checkpoints.save_weights(types.SimpleNamespace(checkpoints_path=ck, name="chip_smoke"),
                                 net)
        views = os.path.join(tmp, "dtu_views.txt")
        with open(views, "w") as f:
            f.write(" ".join(map(str, DTU_EVAL_VIEWS)) + "\n")
        # (label, conf, -F, datadir, -P, split, objects, out, deferred code, extra, kernel)
        cases = [
            ("", "conf/exp/sn64.conf", "dvr", nmr_root, "0", "train", 2, "eval1", True, [],
             "resnetfc_fwd_gather_code"),
            (" (resume)", "conf/exp/sn64.conf", "dvr", nmr_root, "0", "train", 2, "eval1", True,
             [], None),
            ("", "conf/exp/sn64.conf", "dvr", nmr_root, "0 1", "test", 1, "eval2", True, [],
             "resnetfc_fwd_gather_mv_code"),
            ("", "conf/exp/sn64.conf", "dvr", nmr_root, "0 1 2", "test", 1, "eval3", True, [],
             "resnetfc_fwd_dense_mv_code"),
            ("", "conf/exp/dtu.conf", "dvr_dtu", dtu_root, "25 22 28", "val", 1, "eval_dtu", False,
             ["--scale", "0.25", "--eval_view_list", views], "resnetfc_fwd_dense_mv"),
        ]
        os.environ["PIXELNERF_ALLOW_RANDOM_BACKBONE"] = "1"  # no backbone weights on this machine
        try:
            for label, conf_path, fmt, root, source, split, n_objs, out, defer, extra, want in cases:
                out_dir = os.path.join(tmp, out)
                argv = ["-n", "chip_smoke", "-c", conf_path, "-F", fmt, "-D", root, "--split",
                        split, "-P", source, "--max_objs", str(n_objs), "-O", out_dir,
                        "--checkpoints_path", ck, "-R", str(EVAL_RAYS)] + extra
                if defer:
                    os.environ["PIXELNERF_DEFER_CODE"] = "1"
                try:
                    torch.cuda.synchronize()
                    rf.reset_launches()
                    t0 = time.perf_counter()
                    res = eval_main(argv)
                    torch.cuda.synchronize()
                    dt = time.perf_counter() - t0
                finally:
                    os.environ.pop("PIXELNERF_DEFER_CODE", None)
                launches = dict(rf.LAUNCHES)
                with open(os.path.join(out_dir, "finish.txt")) as f:
                    journal = f.read().splitlines()
                pngs = sorted(os.path.relpath(os.path.join(d, f_), out_dir)
                              for d, _, fs in os.walk(out_dir) for f_ in fs if f_.endswith(".png"))
                n_views = (len(DTU_EVAL_VIEWS) if fmt == "dvr_dtu"
                           else NMR_VIEWS - len(source.split()))  # target views
                log(f"eval path{label}: python -m pixelnerf_tpu_torch.eval.eval -c {conf_path} "
                    f"-F {fmt} --split {split} -P \"{source}\" {' '.join(extra[:2])}"
                    f"{' with PIXELNERF_DEFER_CODE=1' if defer else ''} (random encoder, the "
                    f"render phases' weights): rendered "
                    f"{[(n, round(p_, 4), round(s_, 4)) for n, p_, s_ in res['objects']]}, mean "
                    f"psnr {res['psnr']:.4f} ssim {res['ssim']:.4f} over {res['cnt']}; launches "
                    f"{launches}; finish.txt {journal}; {len(pngs)} PNGs; {dt:.3f} s")
                if want is None:  # the resume run renders nothing
                    ok = not res["objects"] and not any(launches.values()) and len(journal) == 2
                else:
                    ok = (len(res["objects"]) == len(journal) == res["cnt"] == n_objs
                          and all(math.isfinite(p_) and math.isfinite(s_)
                                  for _, p_, s_ in res["objects"])
                          and len(pngs) == n_views * len(journal) and launches[want] > 0
                          and not any(v for k, v in launches.items() if k != want))
                if not ok:
                    raise SystemExit(f"eval path on -F {fmt} with -P {source!r} failed or did not "
                                     f"run through {want}")
                if want in code_records:
                    code_records[want]["eval_launches"] = launches[want]
                elif want is not None:
                    records[want]["dtu_eval_launches"] = launches[want]
        finally:
            del os.environ["PIXELNERF_ALLOW_RANDOM_BACKBONE"]
    return step_ms_at


# phase 13: the scene, the quick-train recipe of bench.py and the render
ACCEL_TRAIN_STEPS, ACCEL_POLISH_STEPS, ACCEL_TRAIN_RAYS = 800, 200, 1024
# the cosine's peak lr: bench.py's 2e-4 left a dead head (an all-white
# render) in 2 of 4 seeds on an H100, 1e-4 in none
# (scripts/torch_accel_quicktrain.py); no sigma noise (bench.py's
# BENCH_TRAIN_NOISE at 1 left both heads dead in 4 of 4)
ACCEL_TRAIN_LR, ACCEL_TRAIN_NOISE = 1e-4, 0.0
ACCEL_FRAMES, ACCEL_CHUNK = 16, 65536
ACCEL_CLI_FRAMES = 4
ACCEL_EPS_ALPHA = 1e-3  # the build's alpha a coarse step below which a voxel is empty
ACCEL_CONF = "conf/exp/sn64.conf"


def cosine_lr(peak: float, warmup: int, steps: int, end_frac: float = 0.1):
    """optax's warmup_cosine_decay_schedule(0, peak, warmup, steps, peak * end_frac)."""
    def lr(t: int) -> float:
        if t < warmup:
            return peak * t / warmup
        frac = min(max(t - warmup, 0) / max(steps - warmup, 1), 1.0)
        return peak * (end_frac + (1.0 - end_frac) * 0.5 * (1.0 + math.cos(math.pi * frac)))

    return lr


def quick_train(conf, dev, sample, z_near: float, z_far: float, seed: int = SEED,
                steps=(ACCEL_TRAIN_STEPS, ACCEL_POLISH_STEPS), deterministic: bool = True,
                lr_peak: float = ACCEL_TRAIN_LR, noise0: float = ACCEL_TRAIN_NOISE):
    """bench.py's quick-train recipe on the port's trainer, at its own peak
    lr: the sn64 model at full width (random encoder) overfit to one
    synthetic sphere from one source view a step, R 1024 rays, 32 coarse +
    8 depth samples, the density bias raised by 1, Adam at an ``lr_peak``
    cosine peak (100 warm-up steps, 10% at the end), then a polish at 2e-5
    with the mask loss at 0.3.  With ``noise0`` > 0, bench.py's sigma-noise
    option: noise of std ``noise0`` on the density, annealed linearly to 0
    over the first 60% of the cosine steps.  ``seed`` draws the weights (the ray
    batches and the render's draws follow it); ``steps`` are (cosine,
    polish) steps.  With ``deterministic`` torch's deterministic algorithms
    are on (warnings only) for the run, so that the torch ops that sum with
    atomics by default sum in a fixed order and the run repeats bit for bit
    (the port's kernels use no atomics in their sums).
    Returns (the trained weights, the losses, seconds a step in each part,
    the kernels' launches, the ops that warned of no deterministic version)."""
    import warnings

    import numpy as np

    from pixelnerf_tpu_torch.models.losses import l2_loss
    from pixelnerf_tpu_torch.models.pixelnerf import make_model
    from pixelnerf_tpu_torch.ops import resnetfc_fused as rf
    from pixelnerf_tpu_torch.ops import resnetfc_vjp as rv
    from pixelnerf_tpu_torch.render.renderer import RenderConfig
    from pixelnerf_tpu_torch.train import Optimizer, make_step_fns, prepare_ray_batch

    net = make_model(conf["model"], mlp_impl="auto", device=dev, diff_mode=True,
                     generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for mlp in (net.mlp_coarse, net.mlp_fine):
            mlp.lin_out.bias[3] += 1.0  # no dead relu before the object is supervised
    cfg = RenderConfig(n_coarse=32, n_fine=8, n_fine_depth=8, white_bkgd=True,
                       noise_std=1.0 if noise0 > 0 else 0.0)
    ramp = max(int(0.6 * ACCEL_TRAIN_STEPS), 1)
    data = {"images": sample["images"][None], "poses": sample["poses"][None],
            "focal": np.asarray([sample["focal"]], np.float32)}
    host_rng = np.random.default_rng(7 + seed - SEED)
    gen = torch.Generator(device=dev).manual_seed(2 + seed - SEED)
    losses, seconds = [], []
    rf.reset_launches()
    rv.reset_launches()
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(),
           torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(deterministic, warn_only=True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic, False
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("default")
            for n_steps, lr, alpha, extra, noise in (
                    (steps[0], cosine_lr(lr_peak, 100, ACCEL_TRAIN_STEPS), 0.0, {},
                     lambda t: noise0 * min(max(1.0 - t / ramp, 0.0), 1.0)),
                    (steps[1], lambda t: 2e-5, 0.3, {"masks": sample["masks"][None]},
                     lambda t: 0.0)):
                opt = Optimizer(list(net.parameters()), lr)
                step, _ = make_step_fns(net, opt, lambda: cfg, 1.0, 1.0, l2_loss, l2_loss,
                                        net.use_viewdirs,
                                        remat=not net.field_backward_in_kernel(1),
                                        lambda_alpha_mask=alpha)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for t in range(n_steps):
                    batch = prepare_ray_batch(dict(data, **extra), 1, ACCEL_TRAIN_RAYS, z_near,
                                              z_far, False, host_rng)
                    losses.append(step({k: torch.from_numpy(v).to(dev) for k, v in batch.items()},
                                       gen, noise_scale=noise(t))["t"])
                torch.cuda.synchronize()
                seconds.append((time.perf_counter() - t0) / max(n_steps, 1))
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = was[2], was[3]
    nondet = sorted({str(w.message).split(".")[0][:120] for w in caught
                     if "determinis" in str(w.message)})
    launches = {k: v for k, v in dict(rf.LAUNCHES, **rv.LAUNCHES).items() if v}
    return net.state_dict(), [float(v) for v in losses], seconds, launches, nondet


def accel_ring(conf, dev, state, sample, ds):
    """The trained field on the kernel route, its source view encoded, the
    rays of ``ACCEL_FRAMES`` ring frames (numpy) and a pipeline rendering
    them in chunks of up to ``ACCEL_CHUNK``."""
    import numpy as np

    from pixelnerf_tpu_torch.models.pixelnerf import make_model
    from pixelnerf_tpu_torch.parallel.pipeline import RenderPipeline
    from pixelnerf_tpu_torch.render.renderer import NeRFRenderer
    from pixelnerf_tpu_torch.utils.geometry import gen_rays_np, pose_spherical

    net = make_model(conf["model"], mlp_impl="auto", device=dev)
    net.load_state_dict(state)
    with torch.no_grad():
        scene = net.encode(torch.as_tensor(sample["images"][None, :1], device=dev),
                           torch.as_tensor(sample["poses"][None, :1], device=dev),
                           float(sample["focal"]))
    poses = np.stack([pose_spherical(a, -15.0, 1.3)
                      for a in np.linspace(-180, 180, ACCEL_FRAMES + 1)[:-1]])
    rays = gen_rays_np(poses, FRAME, FRAME, float(sample["focal"]), ds.z_near,
                       ds.z_far).reshape(-1, 8)
    pipe = RenderPipeline(net, NeRFRenderer.from_conf(conf["renderer"],
                                                      eval_batch_size=ACCEL_CHUNK))
    return net, scene, rays, pipe


def foreground(rgb: torch.Tensor) -> float:
    """The share of pixels off the white background by more than 0.08."""
    return float((rgb - 1.0).abs().max(dim=-1).values.gt(0.08).float().mean())


@torch.no_grad()
def coarse_foreground(pipe, scene, rays: torch.Tensor, generator) -> float:
    """The coarse head's own foreground, dense, on ``rays``."""
    import dataclasses

    from pixelnerf_tpu_torch.render.renderer import render_rays

    cfg = dataclasses.replace(pipe.renderer.cfg, eval_batch_size=0)
    out = render_rays(pipe._field(pipe._table_scene(scene)), rays[None], cfg, generator,
                      use_viewdirs=pipe.use_viewdirs)
    return foreground(out["coarse"]["rgb"][0])


@torch.no_grad()
def opacity(pipe, scene, rays: torch.Tensor, generator) -> torch.Tensor:
    """The fine head's accumulated opacity a ray, dense, on ``rays``."""
    import dataclasses

    from pixelnerf_tpu_torch.render.renderer import render_rays

    cfg = dataclasses.replace(pipe.renderer.cfg, eval_batch_size=0)
    out = render_rays(pipe._field(pipe._table_scene(scene)), rays[None], cfg, generator,
                      want_weights=True, use_viewdirs=pipe.use_viewdirs)
    return out["fine"]["weights"][0].sum(-1)


def depth_on_foreground(out_dir: str, opaque) -> dict:
    """``eval --write_depth``'s files in ``out_dir`` for target views 1, 2,
    ...: each ``_depth.npy`` finite, at most 1 (a depth is at most z_far)
    and in [0, 1] where ``opaque`` (views, H, W) holds (where the field is
    opaque, the depth lies in [z_near, z_far]), and its ``_depth_norm.png``
    the HOT colormap of it."""
    import numpy as np

    from pixelnerf_tpu_torch.utils.metrics import cmap
    from pixelnerf_tpu_torch.utils.png import read_png

    lo, hi, n_fg, files_ok = math.inf, -math.inf, 0, True
    for i, fg in enumerate(opaque):
        base = os.path.join(out_dir, f"{i + 1:06}")
        if not (os.path.exists(base + "_depth.npy") and os.path.exists(base + "_depth_norm.png")):
            return {"views": len(opaque), "missing": base, "ok": False}
        d = np.load(base + "_depth.npy")
        if fg.any():
            lo, hi = min(lo, float(d[fg].min())), max(hi, float(d[fg].max()))
        n_fg += int(fg.sum())
        files_ok = files_ok and bool(np.isfinite(d).all() and d.max() <= 1.0 + 1e-6 and np.array_equal(
            read_png(base + "_depth_norm.png"), cmap(d)))
    return {"views": len(opaque), "opaque_pixels": n_fg, "depth_where_opaque": [lo, hi],
            "finite_and_png_is_cmap_of_npy": files_ok,
            "ok": files_ok and n_fg > 0 and 0.0 <= lo and hi <= 1.0}


def accel_phase(conf, dev, smi: str, records: dict, code_records: dict) -> None:
    """Phase 13: the occupancy accel on a quick-trained sn64 field (see the
    module docstring)."""
    import dataclasses
    import types

    from pixelnerf_tpu_torch.data.synthetic import SyntheticDataset
    from pixelnerf_tpu_torch.eval.eval import main as eval_main
    from pixelnerf_tpu_torch.eval.gen_video import main as gen_video_main
    from pixelnerf_tpu_torch.models.pixelnerf import make_model
    from pixelnerf_tpu_torch.ops import resnetfc_fused as rf
    from pixelnerf_tpu_torch.ops.replay import KernelCalls
    from pixelnerf_tpu_torch.parallel.pipeline import RenderPipeline
    from pixelnerf_tpu_torch.render import renderer as rr
    from pixelnerf_tpu_torch.render.accel import probe_lookup
    from pixelnerf_tpu_torch.render.rays import sample_coarse
    from pixelnerf_tpu_torch.train import checkpoints
    from pixelnerf_tpu_torch.utils import geometry

    # the object of `-F synthetic --split train -S 0`, which the CLIs read
    ds = SyntheticDataset(n_objs=1, n_views=8, image_size=FRAME, seed=0)
    sample = ds[0]
    state, losses, step_s, train_launches, nondet = quick_train(conf, dev, sample, ds.z_near,
                                                                ds.z_far)
    log(f"accel phase: quick-train (bench.py's recipe on the port's trainer at a cosine peak "
        f"lr of {ACCEL_TRAIN_LR:g}: sn64 full width, random encoder, -F synthetic object 0 of "
        f"{ds.n_views} views at {FRAME}px, 1 source view, R {ACCEL_TRAIN_RAYS}, 32 coarse + 8 "
        f"depth samples, AMP, deterministic algorithms): {ACCEL_TRAIN_STEPS} cosine steps at "
        f"{1e3 * step_s[0]:.3f} ms a step, {ACCEL_POLISH_STEPS} polish steps at {1e3 * step_s[1]:.3f} ms; loss first "
        f"{losses[0]:.5f}, end of the cosine {losses[ACCEL_TRAIN_STEPS - 1]:.5f}, last "
        f"{losses[-1]:.5f}; launches {train_launches}; ops with no deterministic version "
        f"{nondet}; on {smi}")
    n_steps = ACCEL_TRAIN_STEPS + ACCEL_POLISH_STEPS
    if not (all(math.isfinite(v) for v in losses)
            and train_launches == {k: 2 * n_steps for k in ("resnetfc_fwd_dense",
                                                            "resnetfc_bwd_data",
                                                            "resnetfc_bwd_weights")}):
        raise SystemExit("accel phase: the quick-train diverged or did not run through the "
                         "kernels")
    for name in ("resnetfc_fwd_dense", "resnetfc_bwd_data", "resnetfc_bwd_weights"):
        records[name]["accel_train_launches"] = train_launches[name]

    # every forward kernel call of the accel paths, kept for the plain check at the end
    with KernelCalls() as calls:
        net, scene, rays, pipe = accel_ring(conf, dev, state, sample, ds)
        renderer = pipe.renderer
        NR, frame = rays.shape[0], FRAME * FRAME
        rays_dev = torch.from_numpy(rays).to(dev)

        def gen(seed=1):
            return torch.Generator(device=dev).manual_seed(seed)

        def frames(r=rays_dev, pack="u8", seed=1):
            torch.cuda.synchronize()
            rf.reset_launches()
            rr.reset_accel_counts()
            pts0 = pipe.field_points
            t0 = time.perf_counter()
            pieces = pipe.render_simple(scene, r, gen(seed), ray_batch_size=ACCEL_CHUNK, pack=pack,
                                        as_numpy=False)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            packed = torch.cat([p[:n] for p, n in pieces])
            rgb = packed[:, :3].float() / 255.0 if pack == "u8" else packed[:, :3]
            return (rgb, packed, dt, dict(rf.LAUNCHES), (pipe.field_points - pts0) / r.shape[0],
                    dict(rr.ACCEL_COUNTS))

        # ---- the dense render, and the field's sanity ----
        rgb_dense, dense_packed, dense_s, dense_launches, dense_evals, _ = frames()
        fg = foreground(rgb_dense)
        field = pipe._field(pipe._table_scene(scene))
        cfg0 = dataclasses.replace(renderer.cfg, eval_batch_size=0)
        fg_coarse = coarse_foreground(pipe, scene, rays_dev[:frame], gen())
        log(f"accel phase: dense render of {ACCEL_FRAMES} ring frames ({NR} rays, chunk "
            f"{min(pipe.device_chunk, ACCEL_CHUNK)}): foreground fraction {fg:.4f} (need >= 0.03; "
            f"the coarse head's on frame 0 {fg_coarse:.4f}); "
            f"{dense_evals:.1f} field evaluations a ray; launches {dense_launches}")
        if not fg >= 0.03 or dense_launches["resnetfc_fwd_gather"] == 0:
            raise SystemExit("accel phase: the trained field renders no object (or the dense render "
                             "missed the gather kernel); train more or fix the port")

        # ---- the grid: the full build over the ring's rays ----
        pipe.set_accel_mode("proposal")
        torch.cuda.synchronize()
        rf.reset_launches()
        calls0 = pipe.field_points
        grid = pipe.build_accel(scene, rays, eps_alpha=ACCEL_EPS_ALPHA, ray_batch_size=ACCEL_CHUNK)
        build_launches = dict(rf.LAUNCHES)
        st = dict(pipe.accel_stats)
        log(f"accel phase: build ({st['resolution']}^3 voxels x {st['n_dir_probes']} probe "
            f"directions x 2 heads = {pipe.field_points - calls0} field evaluations): grid program "
            f"{st['grid_s']:.4f} s, "
            f"capacity probe {st['probe_s']:.4f} s; occupancy {st['occupancy']:.4f}; ray live "
            f"max/mean {st['ray_live_max']:.4f}/{st['ray_live_mean']:.4f}, sample live "
            f"{st['sample_live']:.4f} -> capacities rays {st['cap_r']} samples {st['cap_c']} fine "
            f"{st['cap_f']}, chunk {st['chunk']}; launches {build_launches}; on {smi}")
        if grid is None or pipe.accel is None or build_launches["resnetfc_fwd_gather"] == 0:
            raise SystemExit("accel phase: the grid was disabled or its build missed the gather "
                             "kernel")

        # ---- the gate from proposal at 30 dB, on every frame ----
        t0 = time.perf_counter()
        label, psnrs = pipe.gate_accel_mode(scene, rays, 1, rgb_dense.cpu().numpy(),
                                            ray_batch_size=ACCEL_CHUNK, pack="u8")
        gate_s = time.perf_counter() - t0
        log(f"accel phase: gate (seed 1, u8 frames, >= 30 dB against dense): "
            f"{json.dumps({k: round(v, 3) for k, v in psnrs.items()})} -> {label} in {gate_s:.3f} s; "
            f"settled config: mode {pipe.renderer.base_cfg.accel_mode}, proposal draws "
            f"{pipe.renderer.base_cfg.accel_proposal_samples}, capacities "
            f"{pipe.renderer.base_cfg.accel_capacity_rays}/{pipe.renderer.base_cfg.accel_capacity}, "
            f"chunk {pipe.accel_chunk}")
        if label == "dense" or pipe.accel is None:
            raise SystemExit("accel phase: the gate settled on dense on a trained object: the accel "
                             "was not shown; train more or fix the port")
        settled_cfg, settled_chunk = pipe.renderer.base_cfg, pipe.accel_chunk

        # ---- rays/s of dense and the settled rung, in turns ----
        times = {"dense": [], label: []}
        evals, reads, launches, rgbs, acc_counts = {}, {}, {}, {}, {}
        for name in ("dense", label, label, "dense"):
            if name == "dense":
                pipe.accel = None
            rgbs[name], _, dt, la, ev, acc_counts[name] = frames()
            if name == "dense":
                pipe.accel, pipe.accel_chunk = grid, settled_chunk
            times[name].append(dt)
            evals[name], reads[name], launches[name] = ev, acc_counts[name]["n_live_reads"], la
        rate = {k: NR / (sum(v) / len(v)) for k, v in times.items()}
        p_settled = psnr(rgbs[label], rgb_dense)
        log(f"accel phase: render of {NR} rays ({ACCEL_FRAMES} frames), means of two calls each "
            f"in turns (dense, {label}, {label}, dense): dense {rate['dense']:.1f} rays/s, {label} "
            f"{rate[label]:.1f} rays/s ({rate[label] / rate['dense']:.3f}x); field evaluations a ray "
            f"dense {evals['dense']:.2f}, {label} {evals[label]:.2f}; n_live host reads "
            f"{reads[label]} a render = {reads[label] / ACCEL_FRAMES:.4f} a frame; {label} vs dense "
            f"PSNR {p_settled:.3f} dB (need >= 30); launches {launches[label]}; runs "
            f"{json.dumps({k: [round(x, 4) for x in v] for k, v in times.items()})}; on {smi}")
        if not (p_settled >= 30.0 and launches[label]["resnetfc_fwd_gather"] > 0
                and not any(v for k, v in launches[label].items() if k != "resnetfc_fwd_gather")):
            raise SystemExit(f"accel phase: the settled rung {label} disagrees with dense or missed "
                             "the gather kernel")

        # ---- the settled rung on the plain route: same weights, grid, chunk and draws ----
        plain_net = make_model(conf["model"], mlp_impl="torch", device=dev)
        plain_net.load_state_dict(state)
        with torch.no_grad():
            plain_scene = plain_net.encode(torch.as_tensor(sample["images"][None, :1], device=dev),
                                           torch.as_tensor(sample["poses"][None, :1], device=dev),
                                           float(sample["focal"]))
        plain_pipe = RenderPipeline(plain_net, rr.NeRFRenderer.from_conf(
            conf["renderer"], eval_batch_size=ACCEL_CHUNK))
        plain_pipe.renderer.base_cfg = settled_cfg
        plain_pipe.accel, plain_pipe.accel_chunk = grid, settled_chunk
        rf.reset_launches()
        rr.reset_accel_counts()
        plain_pieces = plain_pipe.render_simple(plain_scene, rays_dev, gen(), pack="u8",
                                                ray_batch_size=ACCEL_CHUNK, as_numpy=False)
        torch.cuda.synchronize()
        plain_counts, plain_launches = dict(rr.ACCEL_COUNTS), dict(rf.LAUNCHES)
        rgb_plain = torch.cat([p[:n] for p, n in plain_pieces])[:, :3].float() / 255.0
        p_plain = psnr(rgbs[label], rgb_plain)
        log(f"accel phase: {label} on the plain route (f32 torch field, the same weights, grid, "
            f"chunk and generator seed): kernel route vs plain route PSNR {p_plain:.3f} dB (need "
            f">= 40); plain route {plain_counts}, launches {plain_launches}; kernel route "
            f"{acc_counts[label]}")
        if not (p_plain >= 40.0 and plain_counts == acc_counts[label] and not any(plain_launches.values())):
            raise SystemExit(f"accel phase: the settled rung {label} on the kernel route disagrees "
                             "with the plain route")
        del plain_pieces, rgb_plain, plain_scene, plain_pipe, plain_net

        # ---- each mode against dense, same seed ----
        def heads(sub, accel, cfg):
            rf.reset_launches()
            with torch.no_grad():
                out = rr.render_rays(field, sub, cfg, gen(), use_viewdirs=net.use_viewdirs,
                                     accel=accel)
            torch.cuda.synchronize()
            return out, dict(rf.LAUNCHES)

        # a pruned ray's samples each lie below the build's sigma threshold,
        # eps_alpha over the mean coarse step, so its dense opacity is under
        # n_coarse * eps_alpha, which bounds its coarse |d rgb| (colours in
        # [0, 1]) and, times z_far, its |d depth|; a ray through the object
        # differs by ~1
        pruned_rgb_max = cfg0.n_coarse * ACCEL_EPS_ALPHA
        pruned_depth_max = pruned_rgb_max * ds.z_far
        checks = {}
        for mode in ("rays", "samples"):
            pipe.renderer.base_cfg = dataclasses.replace(settled_cfg, accel_mode=mode)
            pipe.accel = grid
            pipe._autoselect_capacity(rays, ray_batch_size=ACCEL_CHUNK)
            if pipe.accel is None:
                raise SystemExit(f"accel phase: the capacity probe found nothing to prune in {mode} "
                                 "mode")
            # the first window of the chunk the probe sized the buffers for
            sub = rays_dev[None, :pipe.accel_stats["chunk"]]
            dense_h, _ = heads(sub, None, cfg0)
            rr.reset_accel_counts()
            out, la = heads(sub, grid, dataclasses.replace(pipe.renderer.cfg, eval_batch_size=0))
            c = dict(rr.ACCEL_COUNTS)
            oc, dc = out["coarse"], dense_h["coarse"]
            # the rays the grid kept: any sample of the render's coarse draw (the
            # generator's first) in an occupied voxel; they go through the field
            # at the dense render's z
            z = sample_coarse(sub[0], cfg0.n_coarse, gen())
            pruned = ~probe_lookup(grid, sub[0, :, None, :3] + z[..., None] * sub[0, :, None, 3:6])[
                0].any(dim=-1)[None]
            checks[mode] = dict(
                rays=sub.shape[1], fine_psnr=psnr(out["fine"]["rgb"], dense_h["fine"]["rgb"]),
                pruned_coarse_rgb=(oc["rgb"] - dc["rgb"])[pruned].abs().max().item()
                if pruned.any() else 0.0,
                pruned_coarse_depth=(oc["depth"] - dc["depth"])[pruned].abs().max().item()
                if pruned.any() else 0.0,
                pruned=int(pruned.sum()), kept_coarse_bit_identical=bool(
                    torch.equal(oc["rgb"][~pruned], dc["rgb"][~pruned])
                    and torch.equal(oc["depth"][~pruned], dc["depth"][~pruned])),
                counts=c, launches=la["resnetfc_fwd_gather"],
                capacities=(pipe.renderer.base_cfg.accel_capacity_rays,
                            pipe.renderer.base_cfg.accel_capacity))
        pipe.renderer.base_cfg, pipe.accel, pipe.accel_chunk = settled_cfg, grid, settled_chunk
        log(f"accel phase: modes against dense on the first chunk (one pass each, the same "
            f"generator seed): {json.dumps(checks)} (rays: the kept rays' coarse rgb and depth bit "
            f"for bit the dense render's, the pruned rays' coarse |d| within the build's bound "
            f"n_coarse x eps_alpha = {pruned_rgb_max:.4g} rgb, x z_far = {pruned_depth_max:.4g} "
            f"depth, fine >= 40 dB; samples: fine >= 40 dB)")
        r_, s_ = checks["rays"], checks["samples"]
        if not (r_["kept_coarse_bit_identical"] and 0 < r_["pruned"] < r_["rays"]
                and r_["pruned_coarse_rgb"] <= pruned_rgb_max
                and r_["pruned_coarse_depth"] <= pruned_depth_max
                and r_["fine_psnr"] >= 40.0
                and s_["fine_psnr"] >= 40.0 and r_["counts"]["compacted"] == 1
                and s_["counts"]["compacted"] >= 1 and r_["launches"] > 0 and s_["launches"] > 0):
            raise SystemExit("accel phase: rays or samples mode disagrees with dense, or did not "
                             "compact through the gather kernel")

        # ---- the fallback: a 1/64 ray capacity, bit for bit the dense render ----
        pipe.renderer.base_cfg = dataclasses.replace(settled_cfg, accel_mode="rays",
                                                     accel_capacity_rays=1 / 64)
        pipe.accel_chunk = None  # the dense render's chunks, so the draws line up
        fb_rgb, fb_packed, _, _, _, fb_counts = frames(pack="f32")
        pipe.accel = None
        dn_rgb, dn_packed, _, _, _, _ = frames(pack="f32")
        pipe.renderer.base_cfg, pipe.accel, pipe.accel_chunk = settled_cfg, grid, settled_chunk
        identical = torch.equal(fb_packed, dn_packed)
        log(f"accel phase: fallback (rays, capacity 1/64 of a chunk): {fb_counts}; bit-identical to "
            f"the dense render {identical}")
        if not (identical and fb_counts["fallbacks"] == fb_counts["n_live_reads"] > 0):
            raise SystemExit("accel phase: the over-capacity fallback is not the dense render")

        # ---- the other routes on the settled rung: dense kernel, deferred code ----
        routes = {}
        for env, kname in (("PIXELNERF_FUSED_GATHER_MAX_ROWS", "resnetfc_fwd_dense"),
                           ("PIXELNERF_DEFER_CODE", "resnetfc_fwd_gather_code")):
            os.environ[env] = "0" if env.endswith("ROWS") else "1"
            try:
                rgb_r, _, _, la, _, _ = frames(rays_dev[:frame])
            finally:
                del os.environ[env]
            routes[kname] = (la, psnr(rgb_r, rgb_dense[:frame]))
            if not (la[kname] > 0 and not any(v for k, v in la.items() if k != kname)):
                raise SystemExit(f"accel phase: the pruned render under {env} missed {kname}")
        log(f"accel phase: frame 0 at the settled rung on the dense route and with the deferred "
            f"code: {json.dumps({k: (v[0][k], round(v[1], 3)) for k, v in routes.items()})} "
            f"(launches, PSNR against dense)")

        records["resnetfc_fwd_gather"]["accel_launches"] = {
            "build": build_launches["resnetfc_fwd_gather"],
            label: launches[label]["resnetfc_fwd_gather"],
            "rays": checks["rays"]["launches"], "samples": checks["samples"]["launches"]}
        records["resnetfc_fwd_dense"]["accel_launches"] = routes["resnetfc_fwd_dense"][0][
            "resnetfc_fwd_dense"]

        # ---- the CLIs, in-process, on this field ----
        os.environ["PIXELNERF_ALLOW_RANDOM_BACKBONE"] = "1"  # no backbone weights on this machine
        with tempfile.TemporaryDirectory() as tmp:
            ck = os.path.join(tmp, "ck")
            checkpoints.save_weights(types.SimpleNamespace(checkpoints_path=ck, name="accel"), net)
            base = ["-n", "accel", "-c", ACCEL_CONF, "-F", "synthetic", "--split", "train",
                    "--checkpoints_path", ck, "-R", str(ACCEL_CHUNK)]
            cli = {}
            for source, kname in (("0", "resnetfc_fwd_gather"), ("0 1", "resnetfc_fwd_gather_mv"),
                                  ("0 1 2", "resnetfc_fwd_dense_mv")):
                vis = os.path.join(tmp, "vis" + source.replace(" ", ""))
                torch.cuda.synchronize()
                rf.reset_launches()
                t0 = time.perf_counter()
                res = gen_video_main(base + ["-S", "0", "-P", source, "--num_views",
                                             str(ACCEL_CLI_FRAMES), "--visual_path", vis])
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                la = dict(rf.LAUNCHES)
                pngs = sorted(os.listdir(res["frame_dir"]))
                cli[source] = (res["accel"], la, len(pngs), dt)
                log(f"accel phase: python -m pixelnerf_tpu_torch.eval.gen_video -F synthetic -S 0 -P "
                    f"\"{source}\" --num_views {ACCEL_CLI_FRAMES} (--accel_mode auto): accel "
                    f"{res['accel']}; {len(pngs)} PNG frames of {res['frames'].shape[1:3]}, video "
                    f"{res['video']}; launches {la}; {dt:.3f} s")
                if not (isinstance(res["accel"], tuple) and len(pngs) == ACCEL_CLI_FRAMES
                        and os.path.exists(res["view"]) and la[kname] > 0
                        and not any(v for k, v in la.items() if k != kname)):
                    raise SystemExit(f"accel phase: gen_video -P {source!r} showed no gate trail, "
                                     f"wrote no frames or missed {kname}")
            evals_ = {}
            for accel in ("off", "proposal"):
                out = os.path.join(tmp, "eval_" + accel)
                torch.cuda.synchronize()
                rf.reset_launches()
                t0 = time.perf_counter()
                res = eval_main(base + ["-P", "0", "--max_objs", "1", "-O", out, "--accel", accel]
                                + (["--write_depth"] if accel == "off" else []))
                torch.cuda.synchronize()
                evals_[accel] = (res, dict(rf.LAUNCHES), time.perf_counter() - t0)
            # where the field is opaque (>= 0.99) on the eval's target views 1-7
            views = torch.from_numpy(geometry.gen_rays_np(
                sample["poses"][1:], FRAME, FRAME, sample["focal"], ds.z_near, ds.z_far)).to(dev)
            opaque = opacity(pipe, scene, views.reshape(-1, 8), gen()).reshape(-1, FRAME, FRAME)
            depth_fg = depth_on_foreground(os.path.join(tmp, "eval_off", "0"),
                                           (opaque >= 0.99).cpu().numpy())
            (off, la_off, t_off), (on, la_on, t_on) = evals_["off"], evals_["proposal"]
            log(f"accel phase: python -m pixelnerf_tpu_torch.eval.eval -F synthetic --split train -P "
                f"\"0\" --max_objs 1: --accel off psnr {off['psnr']:.4f} ssim {off['ssim']:.4f} in "
                f"{t_off:.3f} s; --accel proposal (fast build, gate on the first target view) gate "
                f"{on['gates']} psnr {on['psnr']:.4f} ssim {on['ssim']:.4f} in {t_on:.3f} s; "
                f"launches off {la_off}, proposal {la_on}")
            log(f"accel phase: eval --accel off --write_depth (the depth where a dense render of "
                f"the same views has opacity >= 0.99): {depth_fg}")
            if not (len(on["gates"]) == 1 and math.isfinite(on["psnr"]) and math.isfinite(on["ssim"])
                    and math.isfinite(off["psnr"]) and la_on["resnetfc_fwd_gather"] > 0):
                raise SystemExit("accel phase: eval --accel proposal ran no gate or gave no metrics")
            if not depth_fg["ok"]:
                raise SystemExit("accel phase: eval --write_depth wrote no depth or a depth out of "
                                 "[0, 1] where the field is opaque")
    del os.environ["PIXELNERF_ALLOW_RANDOM_BACKBONE"]

    # ---- every forward kernel call of the paths above against its plain version ----
    # the first call of each kernel variant, head and point count (the
    # build's chunks, the dense render's passes, the compacted buffers of
    # every rung and mode, the routes' frame 0, gen_video's and eval's
    # passes), replayed: bit for bit the path's own output, and within the
    # kernel checks' bar of the plain version on the same inputs
    replayed(calls.check(), "accel phase", records, code_records)
    del calls
    records["resnetfc_fwd_gather"]["accel_launches"]["gen_video"] = \
        cli["0"][1]["resnetfc_fwd_gather"]
    records["resnetfc_fwd_gather_mv"]["accel_launches"] = {
        "gen_video": cli["0 1"][1]["resnetfc_fwd_gather_mv"]}
    records["resnetfc_fwd_dense_mv"]["accel_launches"] = {
        "gen_video": cli["0 1 2"][1]["resnetfc_fwd_dense_mv"]}
    return routes["resnetfc_fwd_gather_code"][0]["resnetfc_fwd_gather_code"]


# phase 14: the fork's multi-scale recipe through render, train and the CLIs
MS_CONF = "conf/exp/sn64_multiscale.conf"
MS_TRAIN = ((1, 12), (3, 3))  # (-V, one-step epochs) of the train CLI on -F dvr
MS_CLI_FRAMES = 4


def _env(pairs: dict):
    """Set environment variables until the returned function is called."""
    saved = {k: os.environ.get(k) for k in pairs}
    os.environ.update(pairs)

    def restore():
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    return restore


def multiscale_phase(conf, net, src3, rays, dev, smi, records, code_records, nmr_root,
                     sn64_step_ms) -> None:
    """Phase 14: ``conf/exp/sn64_multiscale.conf`` at full width (see the
    module docstring)."""
    from pixelnerf_tpu_torch import entry
    from pixelnerf_tpu_torch.eval.eval import main as eval_main
    from pixelnerf_tpu_torch.eval.gen_video import main as gen_video_main
    from pixelnerf_tpu_torch.ops import resnetfc_fused as rf
    from pixelnerf_tpu_torch.ops import resnetfc_vjp as rv
    from pixelnerf_tpu_torch.ops.replay import KernelCalls
    from pixelnerf_tpu_torch.train import cli, main as train_main

    t_phase = time.perf_counter()
    ms_conf = entry.load_conf(pretrained=False, path=MS_CONF)
    raw_conf = entry.load_conf(pretrained=False, path=MS_CONF)
    raw_conf.put("model.use_smart_fusion", False)  # the raw pyramid, gated
    models = {}
    for name, c in (("ms", ms_conf), ("raw", raw_conf)):
        for impl in ("auto", "torch"):
            models[name, impl] = entry.build_model(c, dev, mlp_impl=impl, seed=SEED)
    g = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():  # every block live, as the render phases' model
        for mlp in (models["ms", "auto"].mlp_coarse, models["ms", "auto"].mlp_fine):
            for blk in mlp.blocks:
                blk.fc_1.weight.copy_(0.02 * torch.randn(blk.fc_1.weight.shape, generator=g))
    state = models["ms", "auto"].state_dict()
    models["ms", "torch"].load_state_dict(state)
    for impl in ("auto", "torch"):
        models["raw", impl].load_state_dict(
            {k: v for k, v in state.items() if not k.startswith("feature_fusion.")})
    ms = models["ms", "auto"]
    log(f"multiscale: {MS_CONF} full width (ResNet34 4 stages, no first pool, use_multi_scale; "
        f"adaptive gate; attention fusion with CBAM to 512, dropout "
        f"{ms.feature_fusion.dropout}; ResnetFC {ms.mlp_fine.d_hidden} x {ms.mlp_fine.n_blocks} "
        f"on both heads), seeded, random encoder, fc_1 ~ N(0, 0.02^2); "
        f"{sum(p.numel() for p in ms.parameters())} parameters (fusion "
        f"{sum(p.numel() for p in ms.feature_fusion.parameters())}, gate "
        f"{sum(p.numel() for p in ms.adaptive_sampler.parameters())})")

    # ---- encode: ms per source view, the trunk alone and with gate + fusion ----
    enc = {}
    with torch.no_grad():
        for nv in (1, 3):
            images = torch.as_tensor(src3["images"][:, :nv], device=dev)
            poses = torch.as_tensor(src3["poses"][:, :nv], device=dev)
            flat = images.reshape((-1,) + tuple(images.shape[2:]))
            focal = float(src3["focal"])
            enc[nv] = dict(
                sn64=cuda_ms(lambda: net.encode(images, poses, focal), 10) / nv,
                trunk=cuda_ms(lambda: ms.encoder(flat), 10) / nv,
                full=cuda_ms(lambda: ms.encode(images, poses, focal), 10) / nv)
        fused = ms.encode(torch.as_tensor(src3["images"][:, :1], device=dev),
                          torch.as_tensor(src3["poses"][:, :1], device=dev),
                          float(src3["focal"])).latents
        pyramid = models["raw", "auto"].encode(
            torch.as_tensor(src3["images"][:, :1], device=dev),
            torch.as_tensor(src3["poses"][:, :1], device=dev), float(src3["focal"])).latents
    log(f"multiscale: encode ms per source view (CUDA events, means of 10): "
        + json.dumps({f"{nv} view(s)": {k: round(v, 4) for k, v in e.items()}
                      for nv, e in enc.items()})
        + f" (sn64: trunk + upsample + concat; trunk: the multi-scale trunk alone; full: trunk, "
        f"gate and fusion); fused map {tuple(fused.shape)}, raw pyramid "
        f"{[tuple(t.shape) for t in pyramid]}")
    if tuple(fused.shape) != (1, FRAME // 2, FRAME // 2, 512) or not isinstance(pyramid, tuple):
        raise SystemExit("multiscale: the encoder did not give the 32 x 32 x 512 fused map")

    def frame0(model, c, views, env):
        restore = _env(env)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, _ = entry.render_ring(model, c, src3, rays[:RAYS_PER_STEP],
                                       torch.Generator(device=dev).manual_seed(SEED),
                                       RAYS_PER_STEP, views=views)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0
        finally:
            restore()

    def launched(model, c, views, env):
        rf.reset_launches()
        out, _ = frame0(model, c, views, env)
        return out, {k: v for k, v in rf.LAUNCHES.items() if v}

    cap0 = {"PIXELNERF_FUSED_GATHER_MAX_ROWS": "0"}
    code = {"PIXELNERF_DEFER_CODE": "1"}
    routes = (("1 view, fused gather", (0,), {}, "resnetfc_fwd_gather"),
              ("1 view, dense", (0,), cap0, "resnetfc_fwd_dense"),
              ("2 views", (0, 1), {}, "resnetfc_fwd_gather_mv"),
              ("3 views", (0, 1, 2), {}, "resnetfc_fwd_dense_mv"))
    ms_launches, turns = {}, {}  # kernel -> {path: launches}; route -> rays/s
    calls = KernelCalls()  # the renders' and the CLIs' kernel calls, not training's
    with calls:
        # ---- ring frame 0 on every route, against the plain route ----
        for label, views, env, kname in routes:
            ref, _ = frame0(models["ms", "torch"], ms_conf, views, env)
            ok = True
            line = []
            for variant, extra in ((kname, {}), (kname + "_code", code)):
                out, la = launched(ms, ms_conf, views, {**env, **extra})
                p = psnr(out, ref)
                ok = ok and p >= 40.0 and set(la) == {variant} and bool(torch.isfinite(out).all())
                ms_launches.setdefault(variant, {})[f"frame 0, {label}"] = la.get(variant, 0)
                line.append(f"{variant} launches {la}, vs plain {p:.3f} dB")
            times = {"sn64": [], "multiscale": []}
            for which in ("sn64", "multiscale", "multiscale", "sn64"):
                model, c = (net, conf) if which == "sn64" else (ms, ms_conf)
                times[which].append(frame0(model, c, views, env)[1])
            t_sn, t_ms = (sum(times[k]) / 2 for k in ("sn64", "multiscale"))
            turns[label] = (RAYS_PER_STEP / t_sn, RAYS_PER_STEP / t_ms)
            log(f"multiscale render: {label} (source views {list(views)}"
                f"{', PIXELNERF_FUSED_GATHER_MAX_ROWS=0' if env else ''}), frame 0: "
                + "; ".join(line) + f" (need >= 40 dB); frame 0 in turns (sn64, multiscale, "
                f"multiscale, sn64; encode included): sn64 {t_sn:.4f} s = "
                f"{RAYS_PER_STEP / t_sn:.1f} rays/s, multiscale {t_ms:.4f} s = "
                f"{RAYS_PER_STEP / t_ms:.1f} rays/s ({t_ms / t_sn:.4f}x sn64's time); on {smi}")
            if not ok:
                raise SystemExit(f"multiscale render {label} failed, disagrees with the plain "
                                 f"route or missed {kname}")

        # ---- the raw pyramid (fusion off): the dense route ----
        raw = models["raw", "auto"]
        ref, _ = frame0(models["raw", "torch"], raw_conf, (0,), {})
        out, la = launched(raw, raw_conf, (0,), {})
        p = psnr(out, ref)
        fused_ok = raw._fused_gather_ok(pyramid, 1)
        log(f"multiscale render: raw pyramid (use_smart_fusion = false; four maps, 512 channels "
            f"in all), frame 0 from view 0: fused gather {fused_ok}; launches {la}; vs plain "
            f"{p:.3f} dB (need >= 40)")
        if fused_ok or set(la) != {"resnetfc_fwd_dense"} or not p >= 40.0:
            raise SystemExit("multiscale: the raw pyramid did not take the dense route or "
                             "disagrees with the plain route")
        ms_launches["resnetfc_fwd_dense"]["frame 0, raw pyramid"] = la["resnetfc_fwd_dense"]

    # ---- train-step parity, -V 1 and -V 3, dropout on ----
    for nviews in (1, 3):
        step_parity(ms_conf, state, nviews, dev, "multiscale",
                    f" (fusion dropout {ms.feature_fusion.dropout}, one generator seed on both "
                    "routes)")

    # ---- the train CLI on -F dvr, then eval and gen_video on its checkpoint ----
    restore = _env({"PIXELNERF_ALLOW_RANDOM_BACKBONE": "1"})  # no backbone weights here
    try:
        with tempfile.TemporaryDirectory() as tmp:
            ck = os.path.join(tmp, "ck")
            for nviews, epochs in MS_TRAIN:
                fwd = STEP_KERNEL[nviews]
                prof = os.path.join(tmp, "profile")
                argv = ["-n", f"ms_v{nviews}", "-c", MS_CONF, "-F", "dvr", "-D", nmr_root,
                        "-B", "4", "-V", str(nviews), "-R", "128", "--epochs", str(epochs),
                        "--checkpoints_path", ck] + (["--profile_dir", prof] if nviews == 1
                                                     else [])
                torch.cuda.synchronize()
                rf.reset_launches()
                rv.reset_launches()
                t0 = time.perf_counter()
                with VisRecorder(cli, rf) as vis:  # the recipe's vis_interval is 10
                    trainer = train_main(argv)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                vis_la = {}
                for r in vis.renders:
                    for k, v in r["launches"].items():
                        vis_la[k] = vis_la.get(k, 0) + v
                # the train steps' and validations' launches; the vis's apart
                la = {k: v - vis_la.get(k, 0) for k, v in dict(rf.LAUNCHES, **rv.LAUNCHES).items()
                      if v - vis_la.get(k, 0)}
                vis_ok = (len(vis.renders) == epochs // trainer.vis_interval
                          and all(row["ok"] for r in vis.renders for row in r["replay"]))
                log(f"multiscale train path -V {nviews}: {len(vis.renders)} vis render(s) "
                    f"(vis_interval {trainer.vis_interval}), launches {vis_la}, "
                    f"{[round(r['s'] * 1e3, 3) for r in vis.renders]} ms; replayed calls "
                    f"within the bar {vis_ok}")
                if not vis_ok:
                    raise SystemExit(f"multiscale train path at -V {nviews}: the vis failed")
                for k, v in vis_la.items():
                    ms_launches.setdefault(k, {})[f"train CLI -V {nviews}, vis"] = v
                n_steps = trainer.global_step
                if nviews == 1:
                    profile_split(os.path.join(prof, "trace.json"), smi, fwd,
                                  label="multiscale profile")
                first = 5 if nviews == 1 else 2  # after the traced steps 3-5 at -V 1
                step_ms = 1e3 * sum(trainer.step_seconds[first:]) / max(
                    1, len(trainer.step_seconds[first:]))
                finite = (len(trainer.history) == n_steps and n_steps > 0
                          and all(math.isfinite(v) for v in trainer.history))
                wrote = os.path.exists(os.path.join(ck, f"ms_v{nviews}", "pixel_nerf_latest"))
                beside = (f" (phase 11's sn64 -V 1 step on -F dvr: {sn64_step_ms[1]:.3f} ms)"
                          if nviews == 1 else "")
                log(f"multiscale train path: python -m pixelnerf_tpu_torch.train -c {MS_CONF} "
                    f"-F dvr -B 4 -V {nviews} -R 128 --epochs {epochs}: {n_steps} steps in "
                    f"{wall:.3f} s, {step_ms:.3f} ms a step over steps {first + 1}-{n_steps}"
                    f"{beside}; "
                    f"remat {trainer.remat}; launches {la}; losses "
                    f"{[round(v, 5) for v in trainer.history]} finite {finite}; "
                    f"pixel_nerf_latest written {wrote}; on {smi}")
                if not (finite and wrote and not trainer.remat
                        and la.get(fwd, 0) >= 2 * n_steps
                        and la.get("resnetfc_bwd_data") == 2 * n_steps
                        and la.get("resnetfc_bwd_weights") == 2 * n_steps
                        and not any(k.startswith("resnetfc_fwd") and k != fwd for k in la)):
                    raise SystemExit(f"multiscale train path at -V {nviews} failed or did "
                                     "not run through the kernels")
                for k, v in la.items():
                    ms_launches.setdefault(k, {})[f"train CLI -V {nviews}"] = v
            base = ["-n", "ms_v1", "-c", MS_CONF, "-F", "dvr", "-D", nmr_root,
                    "--checkpoints_path", ck, "-R", str(EVAL_RAYS)]
            rf.reset_launches()
            t0 = time.perf_counter()
            with calls:
                res = eval_main(base + ["--split", "test", "-P", "0", "--max_objs", "1",
                                        "-O", os.path.join(tmp, "eval")])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            la = {k: v for k, v in rf.LAUNCHES.items() if v}
            log(f"multiscale eval path: python -m pixelnerf_tpu_torch.eval.eval -c {MS_CONF} "
                f"-F dvr --split test -P \"0\" --max_objs 1 (the -V 1 checkpoint): "
                f"{[(n, round(p_, 4), round(s_, 4)) for n, p_, s_ in res['objects']]}; "
                f"launches {la}; {dt:.3f} s")
            if not (len(res["objects"]) == 1 and set(la) == {"resnetfc_fwd_gather"}
                    and all(math.isfinite(p_) and math.isfinite(s_)
                            for _, p_, s_ in res["objects"])):
                raise SystemExit("multiscale eval failed or missed the gather kernel")
            ms_launches["resnetfc_fwd_gather"]["eval -P 0"] = la["resnetfc_fwd_gather"]
            rf.reset_launches()
            t0 = time.perf_counter()
            with calls:
                res = gen_video_main(base + ["--split", "test", "-S", "0", "-P", "0",
                                             "--num_views", str(MS_CLI_FRAMES),
                                             "--visual_path", os.path.join(tmp, "vis")])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            la = {k: v for k, v in rf.LAUNCHES.items() if v}
            pngs = sorted(os.listdir(res["frame_dir"]))
            log(f"multiscale gen_video: python -m pixelnerf_tpu_torch.eval.gen_video -c "
                f"{MS_CONF} -F dvr -S 0 -P \"0\" --num_views {MS_CLI_FRAMES} (--accel_mode "
                f"auto): accel {res['accel']}; {len(pngs)} PNG frames of "
                f"{res['frames'].shape[1:3]}; launches {la}; {dt:.3f} s")
            if not (len(pngs) == MS_CLI_FRAMES and la.get("resnetfc_fwd_gather", 0) > 0
                    and set(la) <= {"resnetfc_fwd_gather"}):
                raise SystemExit("multiscale gen_video wrote no frames or missed the gather "
                                 "kernel")
            ms_launches["resnetfc_fwd_gather"]["gen_video -P 0"] = la["resnetfc_fwd_gather"]
    finally:
        restore()

    # ---- every forward kernel call of the renders and CLIs above, replayed ----
    replayed(calls.check(), "multiscale", records, code_records)
    del calls
    for name, by_path in ms_launches.items():
        (records[name] if name in records else code_records[name])["multiscale_launches"] = by_path
    log(f"multiscale: phase done in {time.perf_counter() - t_phase:.1f} s; frame 0 rays/s in "
        f"turns (sn64, multiscale): "
        + json.dumps({k: [round(a, 1), round(b, 1)] for k, (a, b) in turns.items()}))


# phase 15: the remaining eval CLIs at full width on the fixtures
REAL_CONF = "conf/exp/srn.conf"  # ResNet34 with its first pool: the map is a quarter of the input
REAL_VIEWS, REAL_SIZE = 24, 128  # eval_real's default frames: 24 of 128 x 128
# the input's shorter side: 256 gives a 64 x 86 x 512 map, 5504 rows, over
# the fused-gather cap (the default 128 gives 32 x 43, 1376 rows, under it)
REAL_INPUT = 256
REAL_KEEP = 1 / 32  # the shaped field's occupied share of frame 0's points
LPIPS_SEED = 3


@torch.no_grad()
def shape_density(net, scene, rays: torch.Tensor, keep: float, n_samples: int = 64) -> dict:
    """Shift each head's density (``lin_out``'s sigma bias) so that ``keep``
    of the evenly spaced points along ``rays`` are occupied: a seeded field
    with an object's empty space, which the occupancy grid can prune.
    Returns each head's threshold on the raw density.  (Steepening the
    density too, by scaling the sigma row, put the bf16 kernels' output
    past the per-kernel bar: the row's scale multiplies their input
    rounding, and the shift shrinks the range the bar is relative to.)"""
    t = torch.linspace(0.0, 1.0, n_samples, device=rays.device)
    z = rays[:, 6:7] + (rays[:, 7:8] - rays[:, 6:7]) * t
    pts = (rays[:, None, :3] + z[..., None] * rays[:, None, 3:6]).reshape(-1, 3)
    dirs = rays[:, None, 3:6].expand(-1, n_samples, -1).reshape(-1, 3)
    thresh = {}
    for name, head, coarse in (("coarse", net.mlp_coarse, True), ("fine", net.mlp_fine, False)):
        b = head.lin_out.bias
        b[3] += 1e3  # every raw density through the relu
        raw = torch.cat([net.query(scene, p[None], d[None], coarse=coarse)[0, :, 3]
                         for p, d in zip(pts.split(1 << 18), dirs.split(1 << 18))]) - 1e3
        thresh[name] = float(torch.quantile(raw, 1.0 - keep))
        b[3] -= 1e3 + thresh[name]
    return thresh


# the occupied shares show_object tries in turn: the shaped fields' quarter,
# then more, until the plain route's frame shows the object
SHOW_KEEPS = (1 / 4, 1 / 2, 3 / 4, 0.95)


@torch.no_grad()
def show_object(models: dict, src: dict, views, rays, plain_frame) -> float:
    """Shape the density of ``models["auto"]`` (:func:`shape_density`) on
    the scene of ``src``'s ``views``, occupying each share of SHOW_KEEPS in
    turn until ``plain_frame(models["torch"])`` -- the plain route's frame 0
    after the weights are copied to it -- shows the object (a pixel off the
    white background): from more views, or with a random trunk's latent,
    the field at one share can stay too faint for any pixel.  Returns the
    share taken."""
    m = models["auto"]
    dev = next(m.parameters()).device
    scene = m.encode(torch.as_tensor(src["images"][:, list(views)], device=dev),
                     torch.as_tensor(src["poses"][:, list(views)], device=dev), float(src["focal"]))
    for keep in SHOW_KEEPS:
        shape_density(m, scene, torch.as_tensor(rays, device=dev), keep)
        models["torch"].load_state_dict(m.state_dict())
        if foreground(plain_frame(models["torch"])) > 0:
            break
    return keep


def eval_cli_phase(net, dev, smi: str, records: dict, code_records: dict, nmr_root: str,
                   dtu_root: str) -> None:
    """Phase 15: ``eval_approx``, ``eval_real``, the DTU eval at full size,
    ``eval --write_depth`` and ``calc_metrics`` with LPIPS (see the module
    docstring)."""
    import types

    import numpy as np

    from pixelnerf_tpu_torch import entry
    from pixelnerf_tpu_torch.eval import calc_metrics
    from pixelnerf_tpu_torch.eval import eval_real as er
    from pixelnerf_tpu_torch.eval.eval import main as eval_main
    from pixelnerf_tpu_torch.eval.eval_approx import main as approx_main
    from pixelnerf_tpu_torch.eval.lpips import lpips_fn, seeded_state
    from pixelnerf_tpu_torch.models.pixelnerf import make_model
    from pixelnerf_tpu_torch.ops import resnetfc_fused as rf
    from pixelnerf_tpu_torch.ops.replay import KernelCalls
    from pixelnerf_tpu_torch.train import checkpoints
    from pixelnerf_tpu_torch.utils.metrics import cmap
    from pixelnerf_tpu_torch.utils.png import read_png, write_png

    t_phase = time.perf_counter()
    by_kernel = {}  # kernel variant -> {run: launches}
    replay = []  # KernelCalls.check rows, each with its run
    restore = _env({"PIXELNERF_ALLOW_RANDOM_BACKBONE": "1"})  # no backbone weights here
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_eval_")
    try:
        ck = os.path.join(tmp.name, "ck")
        checkpoints.save_weights(types.SimpleNamespace(checkpoints_path=ck, name="chip_smoke"),
                                 net)

        def run(label, main_fn, argv, n_rays, defer, want):
            """One CLI in-process; its wall seconds, rays/s and peak memory
            on a line of their own; then the first forward-kernel call at
            each point count it made, replayed (one run's calls held at a
            time: the dense routes' latents take GBs)."""
            env = _env({"PIXELNERF_DEFER_CODE": "1"} if defer else {})
            calls = KernelCalls()
            try:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                rf.reset_launches()
                t0 = time.perf_counter()
                with calls:
                    res = main_fn(argv)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            finally:
                env()
            la = {k: v for k, v in rf.LAUNCHES.items() if v}
            peak = torch.cuda.max_memory_allocated() / 2**30
            log(f"eval CLIs: {label}: {dt:.3f} s wall, {n_rays} rays = {n_rays / dt:.1f} rays/s; "
                f"peak memory {peak:.2f} GiB; launches {la}; on {smi}")
            if not (la.get(want, 0) > 0 and set(la) <= {want}):
                raise SystemExit(f"eval CLIs: {label} did not run through {want} alone: {la}")
            by_kernel.setdefault(want, {})[label] = la[want]
            replay.extend(dict(row, run=label) for row in calls.check())
            return res, dt

        # ---- eval_approx on the NMR fixture: one random target view an object ----
        for source, want in (("0", "resnetfc_fwd_gather_code"),
                             ("0 1", "resnetfc_fwd_gather_mv_code")):
            res, _ = run(f"eval_approx -P \"{source}\"", approx_main,
                         ["-n", "chip_smoke", "-c", "conf/exp/sn64.conf", "-F", "dvr", "-D",
                          nmr_root, "--split", "train", "-P", source, "--batch_size", "4",
                          "--checkpoints_path", ck, "-R", str(EVAL_RAYS)],
                         (NMR_OBJS - 2) * FRAME * FRAME, True, want)
            log(f"eval CLIs: eval_approx -P \"{source}\" --batch_size 4 on -F dvr train "
                f"(objects, source views, target view, psnr, ssim): "
                + json.dumps([(os.path.basename(o[0]), o[1], o[2], round(o[3], 4), round(o[4], 4))
                              for o in res["objects"]]) + f"; final psnr {res['psnr']:.4f} ssim "
                f"{res['ssim']:.4f}")
            if not (res["cnt"] == NMR_OBJS - 2 and all(
                    o[2] not in o[1] and math.isfinite(o[3]) and math.isfinite(o[4])
                    for o in res["objects"])):
                raise SystemExit(f"eval CLIs: eval_approx -P {source!r} gave no metrics or "
                                 "rendered a source view")

        # ---- eval_real at srn.conf's width: a non-square RGBA input, shrunk ----
        inp = os.path.join(tmp.name, "real_in")
        os.makedirs(inp)
        photo = read_png(os.path.join(dtu_root, "scan1", "image", "000000.png"))[..., :3]
        rgba = np.concatenate([photo, np.full(photo.shape[:2] + (1,), 255, np.uint8)], -1)
        write_png(os.path.join(inp, "scan1_normalize.png"), rgba)
        real_conf = entry.load_conf(pretrained=False, path=REAL_CONF)
        shaped = make_model(real_conf["model"], mlp_impl="torch", device=dev)
        shaped.load_state_dict(net.state_dict())
        image = er.encoder_input(os.path.join(inp, "scan1_normalize.png"), REAL_INPUT)
        focal, radius, z_near, z_far = 131.25, 1.3, 0.8, 1.8  # eval_real's defaults
        cam = np.eye(4, dtype=np.float32)
        cam[2, 3] = radius
        with torch.no_grad():
            scene = shaped.encode(
                torch.as_tensor(image.astype(np.float32) / 255.0 * 2.0 - 1.0, device=dev)[None, None],
                torch.as_tensor(cam, device=dev)[None, None], focal)
        rays0 = torch.from_numpy(er.spherical_rays(1, 0.0, radius, REAL_SIZE, REAL_SIZE, focal,
                                                   z_near, z_far)).to(dev)
        thresh = shape_density(shaped, scene, rays0, REAL_KEEP)
        checkpoints.save_weights(types.SimpleNamespace(checkpoints_path=ck, name="srn_car"),
                                 shaped)
        log(f"eval CLIs: eval_real's field: the render phases' weights under {REAL_CONF} (first "
            f"pool on: the {image.shape[0]} x {image.shape[1]} input, from {photo.shape[0]} x "
            f"{photo.shape[1]} by the Pillow-style bilinear shrink, gives a "
            f"{scene.latents.shape[-3]} x {scene.latents.shape[-2]} x {scene.latents.shape[-1]} "
            f"map, a {scene.latents.shape[-3] * scene.latents.shape[-2]}-row table), each head's "
            f"density shifted to leave {REAL_KEEP:g} of frame 0's points occupied (raw "
            f"thresholds {json.dumps(thresh)})")
        del shaped, scene
        n_real = REAL_VIEWS * REAL_SIZE * REAL_SIZE
        real = {}
        for mode in ("off", "auto"):
            out = os.path.join(tmp.name, "real_out_" + mode)
            res, dt = run(f"eval_real --accel_mode {mode}", er.main,
                          ["-c", REAL_CONF, "--checkpoints_path", ck, "-I", inp, "-O", out,
                           "--size", str(REAL_INPUT), "--out_size", str(REAL_SIZE), "--num_views",
                           str(REAL_VIEWS), "--accel_mode", mode, "--no_vid"], n_real, True,
                          "resnetfc_fwd_dense_code")
            (r,) = res["inputs"]
            frames = sorted(os.listdir(r["frame_dir"]))
            real[mode] = r
            log(f"eval CLIs: eval_real --accel_mode {mode} (-c {REAL_CONF} --size {REAL_INPUT}, "
                f"{REAL_VIEWS} frames of {REAL_SIZE} x {REAL_SIZE}): encoder input {r['encoder_input'].shape}, accel "
                f"{r['accel']}, {len(frames)} PNG frames, foreground "
                f"{foreground(torch.from_numpy(r['frames']).float() / 255.0):.4f}")
            if not (len(frames) == REAL_VIEWS and r["frames"].shape == (REAL_VIEWS, REAL_SIZE,
                                                                         REAL_SIZE, 3)
                    and r["encoder_input"].shape == image.shape):
                raise SystemExit(f"eval CLIs: eval_real --accel_mode {mode} wrote no frames")
        if real["auto"]["accel"] is None or real["auto"]["accel"][1] is None:
            raise SystemExit("eval CLIs: eval_real --accel_mode auto built no grid or ran no gate")
        d = np.abs(real["auto"]["frames"].astype(int) - real["off"]["frames"].astype(int))
        log(f"eval CLIs: eval_real auto against off, the same frames: max |d| {d.max()} u8 "
            f"levels, mean {d.mean():.4f} (each from its own draws)")

        # ---- eval: the DTU scan at full size, and --write_depth on an NMR object ----
        views = os.path.join(tmp.name, "dtu_views.txt")
        with open(views, "w") as f:
            f.write(" ".join(map(str, DTU_EVAL_VIEWS)) + "\n")
        evals = {}
        for label, argv, n_rays, want in (
                ("eval -F dvr_dtu --scale 1", ["-c", "conf/exp/dtu.conf", "-F", "dvr_dtu", "-D",
                                               dtu_root, "--split", "val", "-P", "25 22 28",
                                               "--scale", "1", "--eval_view_list", views],
                 len(DTU_EVAL_VIEWS) * DTU_SIZE[0] * DTU_SIZE[1], "resnetfc_fwd_dense_mv"),
                ("eval -F dvr --write_depth", ["-c", "conf/exp/sn64.conf", "-F", "dvr", "-D",
                                               nmr_root, "--split", "test", "-P", "0",
                                               "--multicat", "--write_depth"],
                 (NMR_VIEWS - 1) * FRAME * FRAME, "resnetfc_fwd_gather")):
            out = os.path.join(tmp.name, "eval_" + argv[3])
            res, dt = run(label, eval_main, ["-n", "chip_smoke", "--checkpoints_path", ck,
                                             "--max_objs", "1", "-O", out, "-R", str(EVAL_RAYS)]
                          + argv, n_rays, False, want)
            with open(os.path.join(out, "finish.txt")) as f:
                journal = [ln.split() for ln in f.read().splitlines()]
            evals[argv[3]] = (res, out)
            log(f"eval CLIs: {label}: {res['objects']}; finish.txt {journal}")
            if not (len(journal) == 1 and len(journal[0]) == 4 and journal[0][3] == "1"
                    and all(math.isfinite(float(v)) for v in journal[0][1:3])
                    and res["cnt"] == 1):
                raise SystemExit(f"eval CLIs: {label} gave no finite metrics or no journal")
        res, out = evals["dvr"]
        obj_dir = os.path.join(out, res["objects"][0][0])
        depth_views = sorted(f_[:6] for f_ in os.listdir(obj_dir) if f_.endswith("_depth.npy"))
        worst = max(float(np.load(os.path.join(obj_dir, v + "_depth.npy")).max())
                    for v in depth_views)
        png_ok = all(np.array_equal(read_png(os.path.join(obj_dir, v + "_depth_norm.png")),
                                    cmap(np.load(os.path.join(obj_dir, v + "_depth.npy"))))
                     for v in depth_views)
        log(f"eval CLIs: --write_depth: {len(depth_views)} views with _depth.npy and "
            f"_depth_norm.png, the PNG the HOT map of the .npy {png_ok}, max normalized depth "
            f"{worst:.6f} (<= 1: a depth is at most z_far)")
        if not (len(depth_views) == NMR_VIEWS - 1 and png_ok and worst <= 1.0 + 1e-6):
            raise SystemExit("eval CLIs: --write_depth wrote a wrong or missing depth")

        # ---- calc_metrics with LPIPS over both eval outputs, and LPIPS's time ----
        weights = os.path.join(tmp.name, "lpips_vgg.pth")
        torch.save(seeded_state(LPIPS_SEED), weights)
        for fmt, root, out, extra in (("dvr", nmr_root, evals["dvr"][1], ["--multicat", "-P", "0"]),
                                      ("dvr_dtu", dtu_root, evals["dvr_dtu"][1],
                                       ["-P", "25 22 28", "--dtu_sort"])):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = calc_metrics.main(["-D", root, "-F", fmt, "-O", out, "--lpips_weights", weights]
                                    + extra)
            dt = time.perf_counter() - t0
            log(f"eval CLIs: calc_metrics -F {fmt} {' '.join(extra)} (seeded LPIPS weights): "
                f"{dt:.3f} s; map {[(os.path.basename(d_), v, n) for d_, v, n in res['objects']]}; "
                f"all_metrics.txt {res['all_metrics']!r}")
            if not (len(res["objects"]) == 1 and all(math.isfinite(v) for v in
                                                     res["objects"][0][1].values())
                    and res["all_metrics"] and "nan" not in res["all_metrics"]):
                raise SystemExit(f"eval CLIs: calc_metrics -F {fmt} gave no finite metrics")
        lp = lpips_fn(weights, device=dev).model
        gl = torch.Generator(device=dev).manual_seed(LPIPS_SEED)
        lpips_ms = {}
        with torch.no_grad():
            for label, shape in (("a batch of 32 at 64 x 64", (32, FRAME, FRAME, 3)),
                                 ("a pair at 300 x 400", (1,) + DTU_SIZE + (3,))):
                a = torch.rand(shape, device=dev, generator=gl) * 2 - 1
                b = (a + 0.1 * torch.randn(shape, device=dev, generator=gl)).clamp(-1, 1)
                lpips_ms[label] = cuda_ms(lambda: lp(a, b), 5)
        log("eval CLIs: LPIPS (VGG16, cuDNN convolutions in float32) ms: "
            + json.dumps({k: round(v, 3) for k, v in lpips_ms.items()}) + f"; on {smi}")
    finally:
        restore()
        tmp.cleanup()

    # ---- every forward kernel call of those CLIs, replayed run by run ----
    replayed(replay, "eval CLIs", records, code_records)
    for name, by_run in by_kernel.items():
        (records[name] if name in records else code_records[name])["eval_cli_launches"] = by_run
    log(f"eval CLIs: phase done in {time.perf_counter() - t_phase:.1f} s")


# phase 16: the fork's remaining model options at sn64's widths
OPT_TRAIN_STEPS = 3  # train CLI steps of each option's run (one step an epoch)
# the options' train CLI runs: (option, -V, -F); each runs the backward kernels
OPT_TRAIN = (("global", 1, "dvr"), ("global", 3, "dvr_dtu"), ("conv", 1, "dvr"))
# rows 5a / 5b at latent widths other than sn64's: the ConvEncoder's, the
# global encoder's and the widest
WIDE_BWD_C = (128, 640, 1024)


def option_confs(base):
    """sn64's conf (``base``, a parsed ``conf/exp/sn64.conf``) with each of
    the fork's remaining options, built in code: the global encoder
    (ResNet34, its code 128 before the 512-wide pixel latent: C = 640), the
    ConvEncoder (C = 128), the nearest lookup, ImplicitNet heads (5 x 512,
    the views' mean at layer 3), and a narrow tower (d_hidden 256: the
    kernels' 256-wide libraries)."""
    import copy

    out = {}
    for what in ("global", "conv", "nearest", "mlp", "narrow"):
        c = copy.deepcopy(base)
        if what == "global":
            c.put("model.use_global_encoder", True)
            c.put("model.global_encoder.pretrained", False)
        elif what == "conv":
            c.put("model.encoder.type", "conv")
        elif what == "nearest":
            c.put("model.encoder.index_interp", "nearest")
        elif what == "mlp":
            for head in ("mlp_coarse", "mlp_fine"):
                c.put(f"model.{head}.type", "mlp")
                c.put(f"model.{head}.dims", [512] * 5)
                c.put(f"model.{head}.combine_layer", 3)
        else:
            for head in ("mlp_coarse", "mlp_fine"):
                c.put(f"model.{head}.d_hidden", 256)
        out[what] = c
    return out


def live_state(conf, dev, keep: Optional[float] = None) -> dict:
    """The weights of an option's train-step parity: ``conf`` seeded at
    SEED + 1, every ResnetFC block's fc_1 ~ N(0, 0.02^2) (seeded SEED + 2)
    and each head's sigma bias raised by 1, as the accel trainer's heads
    are, so that both heads' sigma is positive at some of the parity batch's
    points in each option's run (the render weights, seeded SEED, give the
    global encoder's fine head sigma <= 0 at every point of the -V 3 batch:
    a zero gradient on both routes).  With ``keep``, each head's density is
    shaped instead (:func:`shape_density`) to occupy that share of the points
    along ring frame 0's rays from the synthetic object's view 0: through a
    48-block tower the raised bias left the coarse head's sigma <= 0 at
    every point of the batch."""
    from pixelnerf_tpu_torch import entry

    net = entry.build_model(conf, dev, seed=SEED + 1)
    g = torch.Generator().manual_seed(SEED + 2)
    with torch.no_grad():
        for mlp in (net.mlp_coarse, net.mlp_fine):
            for blk in mlp.blocks:
                blk.fc_1.weight.copy_(0.02 * torch.randn(blk.fc_1.weight.shape, generator=g))
            mlp.lin_out.bias[3] += 1.0
        if keep is not None:
            src = entry.source_view(FRAME, SEED)
            scene = net.encode(torch.as_tensor(src["images"], device=dev),
                               torch.as_tensor(src["poses"], device=dev), float(src["focal"]))
            rays = torch.as_tensor(entry.ring_rays(src, 1)[:RAYS_PER_STEP], device=dev)
            shape_density(net, scene, rays, keep)
    return net.state_dict()


def bwd_tower(C: int, d_in: int, dev, seed: int, H: int = 512, nb: int = 5):
    """sn64's fine tower (5 blocks x H, 512 by default, or ``nb`` blocks;
    the latent in blocks 0-2, the views' mean at block 3) at latent width C,
    seeded (biases ~ N(0, 0.05^2), weights ~ N(0, 1 / fan_in)): the module
    and its packed weights."""
    from pixelnerf_tpu_torch.models.resnetfc import ResnetFC

    g = torch.Generator().manual_seed(seed)
    m = ResnetFC(d_in=d_in, d_out=4, n_blocks=nb, d_latent=C, d_hidden=H, combine_layer=3,
                 impl="cuda")
    with torch.no_grad():
        for name, prm in m.named_parameters():
            std = 0.05 if name.endswith("bias") else prm.shape[1] ** -0.5
            prm.copy_(torch.randn(prm.shape, generator=g) * std)
    m = m.to(dev)
    return m, m.tower(dev)


def wide_code(d_in: int):
    """A positional code of (x, y, z) whose d_in - 3 columns and the 3 view
    directions after it make a ``d_in``-wide code: F = (d_in - 6) / 6
    frequencies at sn64's factor (6 at sn64's 42; 23 give kin 144, 84 give
    510, kin 512)."""
    from pixelnerf_tpu_torch.models.code import PositionalEncoding

    if (d_in - 6) % 6:
        raise ValueError(f"a code of 6 + 6 F columns, not {d_in}")
    return PositionalEncoding(num_freqs=(d_in - 6) // 6, d_in=3, freq_factor=1.5)


@torch.no_grad()
def padded_twin(mlp, L: int, dev):
    """The packed tower of ResnetFC ``mlp`` zero-padded to the wider
    library width L: the same module at d_hidden L, ``mlp``'s parameters in
    its leading rows and columns and zeros past them, packed as any tower
    is.  The same function as ``mlp``'s own tower, on L's library."""
    from pixelnerf_tpu_torch.models.resnetfc import ResnetFC

    wide = ResnetFC(d_in=mlp.d_in, d_out=mlp.d_out, n_blocks=mlp.n_blocks,
                    d_latent=mlp.d_latent, d_hidden=L, beta=mlp.beta,
                    combine_layer=mlp.combine_layer, combine_type=mlp.combine_type,
                    use_spade=mlp.use_spade, impl="cuda").to(dev)
    own = dict(mlp.named_parameters())
    for name, prm in wide.named_parameters():
        prm.zero_()
        prm[tuple(slice(0, n) for n in own[name].shape)] = own[name]
    return wide.tower(dev)


def bwd_inputs(code, gen, C: int, NS: int, sb: int, B_obj: int):
    """Seeded inputs of the backward kernels at one shape (``gen`` on the
    card): the code ``code`` of points in [-1, 1]^3 and unit view
    directions, a bf16 latent ~ N(0, 0.5^2) of C columns (NS sb B_obj rows,
    object-major) and an f32 cotangent (4, sb B_obj)."""
    dev = gen.device
    rows, B = NS * sb * B_obj, sb * B_obj
    pts = torch.rand(rows, 3, device=dev, generator=gen) * 2 - 1
    vd = torch.nn.functional.normalize(torch.randn(rows, 3, device=dev, generator=gen), dim=-1)
    x = torch.cat([code(pts), vd], dim=-1).contiguous()
    z = (torch.randn(rows, C, device=dev, generator=gen) * 0.5).bfloat16()
    return x, z, torch.randn(4, B, device=dev, generator=gen)


# The gates' bar against an independent plain route (PERF.md section 6, PR
# 26): the data kernel's recompute and the plain bf16 one sum in different
# orders, so through a deep tower they part as bf16 parts from f32.  A
# reading r (1 - corr, the relu-mask flips, max|d|) of the kernel against the
# independent plain bf16 route passes at r <= max(FLOOR, DRIFT_K * r_bf16),
# r_bf16 the same reading of the plain bf16 route against the plain f32 one
# on the same draw; FLOOR is the fixed bar the gates held before (1e-3 of
# corr, 1e-3 of flips, the Pallas tests' max|d| bar).
DRIFT_K = 3.0


def drift_bar(fixed: float, bf16_reading: float) -> float:
    """The bar of a reading against the independent plain route: the fixed
    bar, or DRIFT_K times what bf16 alone reads, whichever is larger."""
    return max(fixed, DRIFT_K * bf16_reading)


def planted_faults(tw, x, z, g, nb: int, kw: dict) -> dict:
    """Four faults of rows 5a / 5b, each a function of the kernels' Grads
    and stashed operands returning what a faulty pair of kernels would hand
    back, (Grads, stashed operands, the plain backward on those operands or
    None where they are the kernels'): (a) the gradients of the tower with
    block nb // 2's fc_1 product dropped (the plain bf16 backward of that
    tower); (b) dx with its columns past 128 zeroed (a code tile of 128
    columns; only where d_in > 128); (c) the dW of block nb // 2 swapped
    with its neighbour's; (d) the stash recomputed with that block's fc_1
    dropped and the gradients walked back through it with the tower's own
    weights: a recompute fault that the plain backward on the kernels' own
    operands follows, so that only the stash's readings and those against
    the independent plain route can see it.  Built here, never in the
    package."""
    from pixelnerf_tpu_torch.ops import resnetfc_vjp as rv

    k, bf = nb // 2, torch.bfloat16
    w_blk, b_blk = tw.w_blk.clone(), tw.b_blk.clone()
    w_blk[k, 1], b_blk[k, 1] = 0, 0
    cut = tw._replace(w_blk=w_blk, b_blk=b_blk)

    def like(bad, gr):
        return bad._replace(**{n: getattr(bad, n).to(getattr(gr, n).dtype)
                               for n in rv.Grads._fields})

    def dropped(gr, ops):
        return like(rv.resnetfc_bwd_reference(g, z, x, cut, nb, True, bf, **kw), gr), ops, None

    def dx_cut(gr, ops):
        dx = gr.dx.clone()
        dx[:, 128:] = 0
        return gr._replace(dx=dx), ops, None

    def swapped(gr, ops):
        w_blk = gr.w_blk.clone()
        j = k + 1 if k + 1 < nb else k - 1
        w_blk[[k, j]] = w_blk[[j, k]]
        return gr._replace(w_blk=w_blk), ops, None

    def stash(gr, ops):
        bad = rv.forward_operands(z, x, cut, nb, bf, **kw)
        back = rv.resnetfc_bwd_reference(g, z, x, tw, nb, True, bf, operands=bad, **kw)
        return like(back, gr), bad, back

    faults = {"fc_1 dropped": dropped, "dW swapped": swapped, "stash without fc_1": stash}
    if tw.d_in > 128:
        faults["dx past 128 zeroed"] = dx_cut
    return faults


def backward_gate(tw, x, z, g, NS: int, sb: int, n_sms: int, records: dict, label: str,
                  check: bool = True, faults: bool = False) -> dict:
    """Rows 5a / 5b of sn64's tower ``tw`` (5 blocks, or as many as ``tw``
    holds; the latent in blocks 0-2, the views' mean at block 3; any width H,
    code width kin and latent C the kernels take) at one shape, from the
    code ``x``, the bf16 latent ``z`` and the cotangent ``g``.  Against the
    plain backward walked through the kernel's own operands (the fault
    detector): every gradient to the bar and corr > 0.999; the weights
    kernel also against ``bwd_weights_reference`` on its own DataOut; the
    dense forward's output against lin_out of the stashed t (the recompute
    in the primal's order).  Against the independent plain bf16 route, each
    reading held to :func:`drift_bar` beside the same reading of the plain
    bf16 route against the plain f32 one on these inputs: the stashed
    operands against the plain recompute (max|d|, corr, relu-mask flips) and
    every gradient's corr.  One launch each, bit-identical second calls, the
    weights kernel's plan walked in bounds (``check_plan_image``).  With
    ``faults``, each of :func:`planted_faults` handed in as the kernels'
    output (a stash fault as their stash too) must fail the same gate.  Logs one line (``label``); with
    ``check``, exits on a failure (or a fault that passes) and keeps each
    kernel's largest max|d| in ``records``.  Returns the readings, ``ok``
    and, with ``faults``, which faults the gate caught."""
    from pixelnerf_tpu_torch.ops import resnetfc_fused as rf
    from pixelnerf_tpu_torch.ops import resnetfc_vjp as rv
    from pixelnerf_tpu_torch.ops.replay import agree

    nb, cl, n_lin_z = tw.w_blk.shape[0], 3, tw.w_z.shape[0]
    H, C = tw.w_in.shape[1], tw.w_z.shape[1]
    names = ("resnetfc_bwd_data", "resnetfc_bwd_weights")
    kw = dict(NS=NS, sb=sb, combine_layer=cl) if NS > 1 else {}
    B = g.shape[1]
    grid = rv.data_grid(B, NS, n_sms, rv.DATA_LIMITS[H])
    rv.reset_launches()
    data = rv.bwd_data(g, z, x, tw, nb, True, **kw)
    gr = rv.bwd_weights(z, data, tw, nb)
    torch.cuda.synchronize()
    one_each = rv.LAUNCHES == {n: 1 for n in names}
    ops_k = data.ws_act[:, :B].float()
    ops_p = rv.forward_operands(z, x, tw, nb, torch.bfloat16, **kw)
    ops_32 = rv.forward_operands(z, x, tw, nb, torch.float32, **kw)
    d_b, _, corr_b = agree(ops_p, ops_32)
    bf16_flips = ((ops_p > 0) != (ops_32 > 0)).float().mean().item()
    del ops_32

    def stash_readings(ops):
        """(max|d|, its bar, corr, relu-mask flips, the largest share of a
        drift bar) of stashed operands against the plain recompute."""
        d, bar, corr = agree(ops, ops_p)
        flips = ((ops > 0) != (ops_p > 0)).float().mean().item()
        return d, bar, corr, flips, max(d / drift_bar(bar, d_b),
                                        (1 - corr) / drift_bar(1e-3, 1 - corr_b),
                                        flips / drift_bar(1e-3, bf16_flips))

    d, bar, corr, flips, stash_share = stash_readings(ops_k)
    stash_ok = stash_share <= 1
    with torch.no_grad():
        out_f = (rf.resnetfc_dense(z, x, tw, nb) if NS == 1
                 else rf.resnetfc_dense_mv(z, x, tw, nb, NS, cl, sb)).double()
        lin = (data.ws_act[-1, :B].double() @ tw.w_out.double()).t() + tw.b_out.double()[:, None]
        same_order = (out_f - lin).abs().max().item() <= 1e-5 * max(1.0, out_f.abs().max().item())
    same = rv.resnetfc_bwd_reference(g, z, x, tw, nb, True, torch.bfloat16, operands=ops_k, **kw)
    ind = rv.resnetfc_bwd_reference(g, z, x, tw, nb, True, torch.bfloat16, **kw)
    ind32 = rv.resnetfc_bwd_reference(g, z, x, tw, nb, True, torch.float32, **kw)
    # what bf16 alone does to each gradient's corr here
    drift = {n: 1 - agree(getattr(ind, n), getattr(ind32, n))[2] for n in rv.Grads._fields}
    del ind32
    wref = rv.bwd_weights_reference(z, data, tw, nb)

    def judge(grads, same=same, wref=wref):
        """(every gradient passes, per-gradient readings, each kernel's max|d|):
        against ``same``, the plain backward on the stashed operands, and the
        weights against ``wref``, their plain version on the kernel's DataOut."""
        fine_all, err, worst = True, {n: 0.0 for n in names}, {}
        for name in rv.Grads._fields:
            out = getattr(grads, name).float()
            d1, bar1, c1 = agree(out, getattr(same, name))
            _, _, c2 = agree(out, getattr(ind, name))
            fine = (d1 <= bar1 and c1 > 0.999 and 1 - c2 <= drift_bar(1e-3, drift[name])
                    and bool(torch.isfinite(out).all()))
            owner = names[0] if name in ("dz", "dx") else names[1]
            if owner == names[1]:  # the weights kernel alone, on its own DataOut
                d3, bar3, c3 = agree(out, getattr(wref, name))
                fine = fine and d3 <= bar3 and c3 > 0.999
                d1 = max(d1, d3)
            fine_all = fine_all and fine
            err[owner] = max(err[owner], d1)
            worst[name] = [float(f"{d1 / bar1:.4g}"), round(c1, 7), round(c2, 7),
                           float(f"{drift[name]:.4g}")]
        return fine_all, worst, err

    grads_ok, worst, err = judge(gr)
    ind_corr = min(v[2] for v in worst.values())
    # the largest share of its bar any reading against the independent route takes
    drift_share = max([stash_share] + [(1 - v[2]) / drift_bar(1e-3, v[3]) for v in worst.values()])
    gr2 = rv.bwd_weights(z, rv.bwd_data(g, z, x, tw, nb, True, **kw), tw, nb)
    identical = all(torch.equal(getattr(gr, n), getattr(gr2, n)) for n in rv.Grads._fields)
    del gr2
    plan = rv.weight_plan(tw.w_in.shape[0], H, C, nb, n_lin_z, NS, data.pre, B,
                          rv.kernel_limits(H), n_sms)
    walked = rv.check_plan_image(plan, z, data)
    ok = one_each and same_order and stash_ok and grads_ok and identical
    caught, stash_fault = {}, {}
    if faults:
        for what, fault in planted_faults(tw, x, z, g, nb, kw).items():
            grads, ops, back = fault(gr, ops_k)
            if back is None:
                caught[what] = not judge(grads)[0]
            else:  # a stash fault: the weights follow the stash, as c1 does
                f_share = stash_readings(ops)[4]
                f_ok, f_worst, _ = judge(grads, back, back)
                caught[what] = not (f_share <= 1 and f_ok)
                # how far past its drift bars the fault lands
                stash_fault = {"stash": f_share, "gradients": max(
                    (1 - v[2]) / drift_bar(1e-3, v[3]) for v in f_worst.values())}
            del grads, ops, back
    del same, ind, wref, ops_k, ops_p, out_f
    log(f"{label}, -V {NS}: {sb} x {B // sb} = {B} "
        f"points{f', {NS * B} rows' if NS > 1 else ''} ("
        + ("the last 64-point tile half full" if B % 64 else "the train step's fine pass")
        + f", {grid[1]} tiles on {grid[2]} CTAs; kin {tw.w_in.shape[0]}): one launch each "
        f"{one_each}; stashed operands vs plain recompute max|d| {d:.6g} <= "
        f"{drift_bar(bar, d_b):.6g}, corr {corr:.7f}, relu-mask flips {flips:.3g} (<= "
        f"{drift_bar(1e-3, bf16_flips):.3g}; bf16 alone: max|d| {d_b:.6g}, corr "
        f"{corr_b:.7f}, flips {bf16_flips:.3g}); the dense forward is lin_out of the stashed "
        f"t {same_order}; per gradient [max|d| / bar vs plain on the kernel's operands (the "
        f"weights: also vs bwd_weights_reference on its DataOut), corr, corr vs the "
        f"independent plain backward, bf16 alone's 1 - corr (its bar: max(1e-3, {DRIFT_K} x "
        f"that))] {json.dumps(worst)}; the largest share of a drift bar {drift_share:.4f}; "
        f"bit-identical second calls {identical}; {data.ws_x.shape[0] // NS} rows a view, "
        f"{rv.data_steps(nb, n_lin_z, NS, cl if NS > 1 else nb, C, H)} stored steps, "
        f"{rv.dz_pieces(C, H)} dz steps an injection; the weights kernel's {plan.tiles} "
        f"output tiles in {max(plan.table[4::6])} splits of {plan.pts} points, "
        f"{len(plan.maps)} tensor maps, {len(plan.table) // 6} products, the plan's "
        f"{walked['ctas']} GEMM CTAs walked in bounds"
        + (f"; planted faults caught {json.dumps(caught)} (the stash fault's largest share "
           f"of a drift bar: {json.dumps({k: float(f'{v:.4g}') for k, v in stash_fault.items()})})"
           if faults else ""))
    if check and not (ok and all(caught.values())):
        raise SystemExit(f"{label} failed at -V {NS}, {B} points (gate passed {ok}"
                         + (f", faults caught {caught})" if caught else ")"))
    if check:
        for n in names:
            records[n]["max_abs_err"] = max(records[n].get("max_abs_err", 0.0), err[n])
    return {"ok": ok, "flips": flips, "d_over_bar": d / bar, "ind_corr": ind_corr,
            "bf16_flips": bf16_flips, "bf16_corr": 1 - max(drift.values()),
            "worst": max(v[0] for v in worst.values()), "identical": identical,
            "drift_share": drift_share, "caught": caught, "stash_fault": stash_fault,
            "per_grad": worst,
            "stash": {"d": d, "bar": bar, "corr": corr, "d_bf16": d_b, "corr_bf16": corr_b}}


def data_flops_pt(f_pt: float, Hw: int, NS: int, d_in: int, need_dx: bool) -> float:
    """The data kernel's FLOP per output point, ``f_pt`` the forward's: the
    recompute and the data gradients, two forwards' less dx's product
    (2 Hw d_in a row, NS rows a point) where dx is not asked."""
    return 2 * f_pt - (0 if need_dx else 2 * Hw * NS * d_in)


def backward_yardsticks(tw, x, z, g, data, NS: int, sb: int):
    """What rows 5a / 5b of sn64's tower ``tw`` (5 blocks, the latent in
    blocks 0-2, the views' mean at block 3) are timed against at one shape,
    ``data`` the data kernel's DataOut on these inputs, the data kernel
    timed without dx (as the train step asks it): each kernel's plain version
    (``workspace_reference``; ``bwd_weights_reference`` on ``data``), its
    library call (the autograd backward of the cuBLAS bf16 chain; one cuBLAS
    ``A^T G`` a product, over the same planes), never called by the port,
    and its bound (the data kernel: the recompute and the data gradients
    (:func:`data_flops_pt`) against its inputs, the bf16 workspace written
    once and dz written; the weights kernel: one
    forward's FLOP against the workspace read once, z too at one view (from
    several it reads the workspace's ws_z), and the weight gradients
    written).  Returns ({kernel: plain ms}, {kernel: library
    ms}, {kernel: (bound ms, what bounds it)}, {kernel: FLOP})."""
    from pixelnerf_tpu_torch.ops import resnetfc_fused as rf
    from pixelnerf_tpu_torch.ops import resnetfc_vjp as rv

    names = ("resnetfc_bwd_data", "resnetfc_bwd_weights")
    nb, cl = tw.w_blk.shape[0], 3
    (kin, H), (n_lin_z, C) = tw.w_in.shape, tw.w_z.shape[:2]
    d_in, d_out = tw.d_in, tw.w_out.shape[1]
    kw = dict(NS=NS, sb=sb, combine_layer=cl) if NS > 1 else {}
    B, rows = g.shape[1], x.shape[0]
    pre = nb if NS == 1 else cl
    plain = {names[0]: cuda_ms(lambda: rv.workspace_reference(g, z, x, tw, nb, **kw), 2),
             names[1]: cuda_ms(lambda: rv.bwd_weights_reference(z, data, tw, nb), 2)}
    w_ops = [rv.task_operands(tk, z, data)
             for tk in rv.weight_tasks(kin, H, C, nb, n_lin_z, NS, data.pre, B)]
    lib = {names[1]: cuda_ms(lambda: [torch.matmul(a.t(), gg[: a.shape[0]]) for a, gg in w_ops],
                             5)}
    del w_ops
    leaves = [tt.detach().bfloat16().requires_grad_() for tt in tw[:8]]
    with torch.enable_grad():
        if NS == 1:
            zl = z.detach().requires_grad_()
            lout = library_tower(zl, x, rf.Tower(*leaves, d_in, tw.d_hidden), nb)
        else:
            zl = by_view(z, NS, sb).detach().requires_grad_()
            lout = library_tower_mv(zl, by_view(x, NS, sb),
                                    rf.Tower(*leaves, d_in, tw.d_hidden), nb, NS, cl)
    lib[names[0]] = cuda_ms(lambda: torch.autograd.grad(lout, [zl, *leaves], g, retain_graph=True),
                            5)
    del lout, leaves, zl
    # forward FLOP per output point, the bf16 workspace (written once, read once)
    Hw = tw.d_hidden  # the tower's own width: below H when zero-padded onto H's library
    f_pt = 2 * Hw * (NS * (d_in + n_lin_z * C + 2 * pre * Hw) + 2 * (nb - pre) * Hw + d_out)
    ws = sum(tt.numel() * tt.element_size()
             for tt in (data.ws_act, data.ws_cot, data.ws_x, data.ws_z) if tt is not None)
    w_bytes = sum(tt.numel() * tt.element_size() for tt in tw[:8])
    io = rows * (C * 2 + d_in * 4) + B * d_out * 4 + w_bytes
    z_read = rows * C * 2 if data.ws_z is None else 0  # z in place at NS = 1, else ws_z
    flops = {names[0]: B * data_flops_pt(f_pt, Hw, NS, d_in, False), names[1]: B * f_pt}
    bounds = {names[0]: bound(flops[names[0]], io + ws + rows * C * 4),
              names[1]: bound(flops[names[1]], ws + z_read + 2 * w_bytes)}
    return plain, lib, bounds, flops


def wide_backward_phase(conf, dev, smi, records) -> None:
    """Phase 16's rows 5a / 5b at latent widths other than 512: at each C of
    WIDE_BWD_C from 1 view (2000 points) and from 3 (SB 2 x 333), the last
    64-point tile half full, and at the train step's fine pass (SB 4 x
    12,288 points from 1 and from 3 views: a persistent CTA walks several
    tiles, the ring feed carrying pieces from tile to tile), the data
    kernel's stashed operands against the
    plain recompute, the dense forward's output against lin_out of the
    stashed t (the recompute in the primal's order), every gradient against
    the plain backward walked through the kernel's own operands and against
    the independent plain backward, the weights kernel against
    ``bwd_weights_reference`` on its own DataOut, a launch each and
    bit-identical second calls; then both kernels timed at the train step's
    fine pass (-V 1: 49,152 points at C = 512, 640 and 128 in turns; -V 3:
    49,152 output points at C = 512 and 640 in turns) with their plain,
    library and bound times."""
    from pixelnerf_tpu_torch.models.code import PositionalEncoding
    from pixelnerf_tpu_torch.ops import resnetfc_vjp as rv

    nb, cl = 5, 3
    code = PositionalEncoding.from_conf(conf["model.code"], d_in=3)
    d_in = code.d_out + 3
    gi = torch.Generator(device=dev).manual_seed(SEED + 17)
    towers = {C: bwd_tower(C, d_in, dev, SEED + C) for C in (512,) + WIDE_BWD_C}
    names = ("resnetfc_bwd_data", "resnetfc_bwd_weights")
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def inputs(C, NS, sb, B_obj):
        return bwd_inputs(code, gi, C, NS, sb, B_obj)

    # ---- gates: C = 128, 640, 1024 from 1 and 3 views, ragged B and the
    # train step's fine pass ----
    for C in WIDE_BWD_C:
        for NS, sb, B_obj in ((1, 2, 1000), (3, 2, 333), (1, 4, 128 * 96), (3, 4, 128 * 96)):
            x, z, g = inputs(C, NS, sb, B_obj)
            backward_gate(towers[C][1], x, z, g, NS, sb, n_sms, records,
                          f"wide backward check C = {C} (sn64's tower)")
            del x, z, g

    # ---- times at the train step's fine pass, C in turns beside 512 ----
    for NS, widths in ((1, (512, 640, 128)), (3, (512, 640))):
        sb, B_obj = 4, 128 * 96
        kw = dict(NS=NS, sb=sb, combine_layer=cl) if NS > 1 else {}
        B, rows = sb * B_obj, NS * sb * B_obj
        case = {}
        for C in widths:
            x, z, g = inputs(C, NS, sb, B_obj)
            tw = towers[C][1]
            data = rv.bwd_data(g, z, x, tw, nb, False, **kw)
            case[C] = (x, z, g, tw, data)
        t = {C: {n: [] for n in names} for C in widths}
        for C in widths + widths[::-1]:  # in turns
            x, z, g, tw, data = case[C]
            t[C][names[0]].append(cuda_ms(lambda: rv.bwd_data(g, z, x, tw, nb, False, **kw), 5))
            t[C][names[1]].append(cuda_ms(lambda: rv.bwd_weights(z, data, tw, nb), 5))
        ms = {C: {n: sum(v) / len(v) for n, v in t[C].items()} for C in widths}
        for C in widths[1:]:
            x, z, g, tw, data = case[C]
            plain, lib, bounds, flops = backward_yardsticks(tw, x, z, g, data, NS, sb)
            for n in names:
                b_ms, b_by = bounds[n]
                log(f"wide backward time: {n} at C = {C}, -V {NS}, {B} output points"
                    f"{f' ({rows} rows)' if NS > 1 else ''}: in turns {ms[C][n]:.4f} ms beside "
                    f"{ms[512][n]:.4f} at C = 512 ({ms[C][n] / ms[512][n]:.4f}x)"
                    + (f", {ms[128][n]:.4f} at C = 128" if C == 640 and 128 in ms else "")
                    + f"; {flops[n] / ms[C][n] / 1e9:.1f} TFLOP/s; "
                    f"plain_ms {plain[n]:.4f}; library_ms {lib[n]:.4f} ("
                    + ("autograd backward of the cuBLAS chain" if n == names[0]
                       else "cuBLAS bf16 A^T G a product")
                    + f"); bound_ms {b_ms:.4f} ({b_by}); {b_ms / ms[C][n]:.3f} of the bound; "
                    f"on {smi}")
                records[n][f"c{C}" + ("" if NS == 1 else f"_ns{NS}")] = dict(
                    points=B, views=NS, ms=ms[C][n], c512_ms_in_turns=ms[512][n],
                    plain_ms=plain[n], library_ms=lib[n], bound_ms=b_ms, bound_by=b_by)
        del case


def options_phase(conf, src, src3, rays, dev, smi, records, code_records, nmr_root,
                  dtu_root) -> None:
    """Phase 16: the global encoder, the ConvEncoder, the nearest lookup,
    ImplicitNet and a narrow tower at sn64's widths (see the module
    docstring)."""
    from pixelnerf_tpu_torch import entry
    from pixelnerf_tpu_torch.ops import resnetfc_fused as rf
    from pixelnerf_tpu_torch.ops import resnetfc_vjp as rv
    from pixelnerf_tpu_torch.ops.replay import KernelCalls, agree
    from pixelnerf_tpu_torch.train import main as train_main

    t_phase = time.perf_counter()
    mirrors = {**{f"dense (d_hidden {H})": (rf.dense_limits(H), rf.TILE_LIMITS[H])
                  for H in rf.FWD_HIDDEN},
               **{f"data (d_hidden {H})": (rv.data_limits(H), rv.DATA_LIMITS[H])
                  for H in rf.BWD_HIDDEN},
               **{f"weights (d_hidden {H})": (rv.kernel_limits(H), rv.WEIGHT_LIMITS[H])
                  for H in rf.BWD_HIDDEN}}
    log("options: the route rule's mirrors of the kernels' limits against the libraries' "
        + json.dumps({k: [list(a), a == b] for k, (a, b) in mirrors.items()}))
    if any(a != b for a, b in mirrors.values()):
        raise SystemExit("options: a Python mirror of the kernels' limits is not the library's")
    confs = option_confs(conf)
    models = {}
    g = torch.Generator().manual_seed(SEED + 1)
    for what, c in confs.items():
        for impl in ("auto", "torch"):
            models[what, impl] = entry.build_model(c, dev, mlp_impl=impl, seed=SEED)
        with torch.no_grad():
            for mlp in (models[what, "auto"].mlp_coarse, models[what, "auto"].mlp_fine):
                for blk in getattr(mlp, "blocks", ()):  # every block live
                    blk.fc_1.weight.copy_(0.02 * torch.randn(blk.fc_1.weight.shape, generator=g))
        models[what, "torch"].load_state_dict(models[what, "auto"].state_dict())
    gl = models["global", "auto"]
    log(f"options: from conf/exp/sn64.conf: global encoder (ResNet34, 5 stages, first pool, "
        f"code {gl.global_encoder.latent_size}: C = {gl.d_latent}; "
        f"{sum(p.numel() for p in gl.global_encoder.parameters())} parameters), ConvEncoder (C = "
        f"{models['conv', 'auto'].d_latent}, {sum(p.numel() for p in models['conv', 'auto'].encoder.parameters())} "
        f"parameters), nearest lookup, ImplicitNet heads (5 x 512), d_hidden 256; seeded, random "
        f"encoders, ResnetFC fc_1 ~ N(0, 0.02^2)")

    def frame0(model, c, s, views, env):
        restore = _env(env)
        try:
            rf.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, _ = entry.render_ring(model, c, s, rays[:RAYS_PER_STEP],
                                       torch.Generator(device=dev).manual_seed(SEED),
                                       RAYS_PER_STEP, views=views)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0, {k: v for k, v in rf.LAUNCHES.items() if v}
        finally:
            restore()

    code = {"PIXELNERF_DEFER_CODE": "1"}
    dense = {"PIXELNERF_FUSED_GATHER_MAX_ROWS": "0"}
    # (option, source, views, env, the kernel its render must launch, or None: plain)
    renders = [("global", src, (0,), {}, "resnetfc_fwd_dense"),
               ("global", src, (0,), code, "resnetfc_fwd_dense_code"),
               ("global", src3, (0, 1, 2), {}, "resnetfc_fwd_dense_mv"),
               ("global", src3, (0, 1, 2), code, "resnetfc_fwd_dense_mv_code"),
               ("conv", src, (0,), {}, "resnetfc_fwd_dense"),
               ("nearest", src, (0,), {}, "resnetfc_fwd_dense"),
               ("mlp", src, (0,), {}, None),
               ("narrow", src, (0,), dense, "resnetfc_fwd_dense")]
    opt_launches = {}
    calls = KernelCalls()
    with calls:
        for what, s, views, env, kname in renders:
            c = confs[what]
            ref, _, la_ref = frame0(models[what, "torch"], c, s, views, env)
            frame0(models[what, "auto"], c, s, views, env)  # warm: cuDNN's choice
            out, sec, la = frame0(models[what, "auto"], c, s, views, env)
            p = psnr(out, ref)
            want = {kname} if kname else set()
            ok = (set(la) == want and not la_ref and bool(torch.isfinite(out).all())
                  and p >= 40.0)
            label = f"{what}, views {list(views)}" + {
                "PIXELNERF_DEFER_CODE": ", deferred code",
                "PIXELNERF_FUSED_GATHER_MAX_ROWS": ", dense route"}.get(next(iter(env), ""), "")
            if kname:
                opt_launches.setdefault(kname, {})[f"frame 0, {label}"] = la[kname]
            log(f"options render: {label}: frame 0 {sec:.4f} s = {RAYS_PER_STEP / sec:.1f} rays/s "
                f"(encode included); launches {la} (want {sorted(want)}); vs the plain route "
                f"{p:.3f} dB (need >= 40{'' if kname else '; both plain'}); on {smi}")
            if not ok:
                raise SystemExit(f"options render {label} failed, missed {kname} or disagrees "
                                 "with the plain route")
    replayed(calls.check(), "options")
    del calls

    # a tower wider than the widest library, under cuda: the route refuses
    # it rather than launching
    from pixelnerf_tpu_torch.models.resnetfc import ResnetFC

    odd = ResnetFC(d_in=42, d_out=4, n_blocks=5, d_latent=512, d_hidden=1040, combine_layer=3,
                   impl="cuda").to(dev)
    try:
        odd._kernel_route((1, 64), dev)
        refused = None
    except ValueError as e:
        refused = str(e)
    log(f"options: a d_hidden 1040 tower under impl='cuda' raises: {refused!r}")
    if refused is None:
        raise SystemExit("options: impl='cuda' took a tower outside the kernels' widths")
    del odd

    # ---- rows 2, 3 and 6 at C = 640 beside C = 512, in turns ----
    tw640 = gl.mlp_fine.tower(dev)
    tw512 = models["nearest", "auto"].mlp_fine.tower(dev)  # sn64's tower, C = 512
    H, nb, cl, d_out = 512, gl.mlp_fine.n_blocks, gl.mlp_fine.combine_layer, 4
    d_in = tw640.d_in
    gi = torch.Generator(device=dev).manual_seed(SEED + 16)
    W, f, ph, m = gl.code.flat_arrays(tail=3)
    code_arrays = tuple(torch.from_numpy(a).to(dev) for a in (W, f, ph, m))
    for NS, B in ((1, RAYS_PER_STEP * 96), (3, RAYS_PER_STEP * 96)):
        rows_in = NS * B
        raw = torch.cat([torch.rand(rows_in, 3, device=dev, generator=gi) * 2.8 - 1.4,
                         torch.nn.functional.normalize(
                             torch.randn(rows_in, 3, device=dev, generator=gi), dim=-1)], -1)
        rc = rf.RawCode(raw, *code_arrays)
        x = rf.materialize_code(rc._replace(cd=torch.float32)).contiguous()
        z640 = torch.rand(rows_in, 640, device=dev, generator=gi).bfloat16()
        z512 = z640[:, 128:].contiguous()
        name = "resnetfc_fwd_dense" if NS == 1 else "resnetfc_fwd_dense_mv"
        for variant, xin in ((name, x), (name + "_code", rc)):
            def run(z, tw, xin=xin):
                if NS == 1:
                    return rf.resnetfc_dense(z, xin, tw, nb)
                return rf.resnetfc_dense_mv(z, xin, tw, nb, NS, cl)

            with torch.no_grad():
                out = run(z640, tw640)
                ref = rf.resnetfc_reference(z640, xin, tw640, nb, compute_dtype=torch.bfloat16,
                                            NS=NS, combine_layer=cl)
                torch.cuda.synchronize()
                d, bar, corr = agree(out, ref)
                same = torch.equal(out, run(z640, tw640))
                del ref
                t = {640: [], 512: []}
                for C in (512, 640, 640, 512):
                    t[C].append(cuda_ms(lambda: run(z640 if C == 640 else z512,
                                                    tw640 if C == 640 else tw512), 5))
                ms640, ms512 = (sum(t[C]) / 2 for C in (640, 512))
                plain_ms = cuda_ms(lambda: rf.resnetfc_reference(
                    z640, xin, tw640, nb, compute_dtype=torch.bfloat16, NS=NS,
                    combine_layer=cl), 2)
                xl = xin if not isinstance(xin, rf.RawCode) else x
                if NS == 1:
                    library_ms = cuda_ms(lambda: library_tower(z640, xl, tw640, nb), 5)
                else:
                    zv, xv = by_view(z640, NS, 1), by_view(xl, NS, 1)
                    library_ms = cuda_ms(lambda: library_tower_mv(zv, xv, tw640, nb, NS, cl), 5)
                    del zv, xv
            flops = 2 * H * B * (NS * (d_in + cl * (640 + 2 * H)) + 2 * (nb - cl) * H + d_out)
            w_bytes = sum(tt.numel() * tt.element_size() for tt in tw640[:8])
            in_bytes = rows_in * (640 * 2 + (6 if variant.endswith("_code") else d_in) * 4)
            b_ms, b_by = bound(flops, in_bytes + B * d_out * 4 + w_bytes)
            ok = d <= bar and corr > 0.999 and same
            log(f"options kernel check: {variant} at C = 640 (the global encoder's code + "
                f"sn64's latent), {B} output points from {NS} view(s): max|d| {d:.6g} (bar "
                f"{bar:.6g}), corr {corr:.7f}, bit-identical second call {same}; in turns "
                f"(C 512, 640, 640, 512) {ms640:.4f} ms at C = 640 beside {ms512:.4f} at C = 512 "
                f"({ms640 / ms512:.4f}x), {flops / ms640 / 1e9:.1f} TFLOP/s; plain_ms "
                f"{plain_ms:.4f}; library_ms {library_ms:.4f} (cuBLAS bf16 chain); bound_ms "
                f"{b_ms:.4f} ({b_by}); on {smi}")
            if not ok:
                raise SystemExit(f"options: {variant} at C = 640 disagrees with its plain "
                                 "version")
            rec = records[variant] if variant in records else code_records[variant]
            rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), d)
            rec["c640"] = dict(points=B, views=NS, ms=ms640, c512_ms_in_turns=ms512,
                               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                               library_ms=library_ms, max_abs_err=d, corr=corr)
        del raw, rc, x, z640, z512

    # ---- rows 5a / 5b at C = 128, 640 and 1024 ----
    wide_backward_phase(conf, dev, smi, records)

    # ---- the options' train CLIs on the backward kernels, and their step parity ----
    restore = _env({"PIXELNERF_ALLOW_RANDOM_BACKBONE": "1"})  # no backbone weights here
    try:
        for what, nviews, fmt in OPT_TRAIN:
            fwd = STEP_KERNEL[nviews]
            with tempfile.TemporaryDirectory() as tmp:
                # sn64's conf with the option on, as a conf file includes it
                cpath = os.path.join(tmp, f"{what}.conf")
                with open(cpath, "w") as fh:
                    fh.write(f'include required("{os.path.abspath("conf/exp/sn64.conf")}")\n'
                             + ("model { use_global_encoder = true }\n" if what == "global"
                                else "model { encoder { type = conv } }\n"))
                rf.reset_launches()
                rv.reset_launches()
                t0 = time.perf_counter()
                trainer = train_main(
                    ["-n", f"opt_{what}", "-c", cpath, "-F", fmt, "-D",
                     nmr_root if fmt == "dvr" else dtu_root, "-B", "4", "-V", str(nviews), "-R",
                     "128", "--epochs", str(OPT_TRAIN_STEPS), "--checkpoints_path",
                     os.path.join(tmp, "ck")])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            la = {k: v for k, v in dict(rf.LAUNCHES, **rv.LAUNCHES).items() if v}
            n_steps = trainer.global_step
            finite = n_steps == OPT_TRAIN_STEPS and all(math.isfinite(v) for v in trainer.history)
            enc = trainer.net.global_encoder if what == "global" else trainer.net.encoder
            moved = any(p_.grad is not None and float(p_.grad.abs().sum()) > 0.0
                        for p_ in enc.parameters())
            step_ms = 1e3 * sum(trainer.step_seconds[1:]) / max(1, n_steps - 1)
            C = trainer.net.mlp_fine.d_latent
            ok = (finite and moved and not trainer.remat and set(la) == {fwd, *rv.LAUNCHES}
                  and la["resnetfc_bwd_data"] == la["resnetfc_bwd_weights"] == 2 * n_steps
                  and la[fwd] >= 2 * n_steps and la[fwd] % 2 == 0)
            label = f"{what} -V {nviews} on -F {fmt}"
            log(f"options train path: python -m pixelnerf_tpu_torch.train -c conf/exp/sn64.conf + "
                f"{'use_global_encoder' if what == 'global' else 'encoder.type = conv'} -F {fmt} "
                f"-B 4 -V {nviews} -R 128 (C = {C}): {n_steps} steps in {wall:.3f} s, "
                f"{step_ms:.3f} ms a step after the first; remat {trainer.remat}; launches {la} "
                f"(want {fwd} and both backward kernels twice a step, {fwd} twice more a "
                f"validation batch); losses {[round(v, 5) for v in trainer.history]}; the "
                f"{'global encoder' if what == 'global' else 'ConvEncoder'} trained {moved}; "
                f"on {smi}")
            if not ok:
                raise SystemExit(f"options: the {label} train steps failed or left the kernels")
            for name in (fwd, *rv.LAUNCHES):
                opt_launches.setdefault(name, {})[f"train CLI, {label}"] = la[name]
            step_parity(confs[what], live_state(confs[what], dev), nviews, dev,
                        f"options {what} (C = {C})")
    finally:
        restore()
    for name, by_path in opt_launches.items():
        (records[name] if name in records else code_records[name])["options_launches"] = by_path
    log(f"options: phase done in {time.perf_counter() - t_phase:.1f} s")


# phase 17: narrower towers (d_hidden 384, 256, 128 and 64), the widths whose
# warpgroup halves are no whole 64-column pieces (320, 192), each on its
# own library, and d_hidden 200, zero-padded onto the 256 library, on the
# forward kernels
NARROW_H = (384, 256, 128, 64)
NATIVE_H = (320, 192)  # two pieces of 80 columns a warpgroup, one of 96
PADDED_H = 200  # no library of its own: the next one's (256), its weights zero-padded
NEW_H = NATIVE_H + (PADDED_H,)
# the eval CLI's runs at d_hidden 256 with the deferred code: (-P, the
# kernel each launches: the gather's CODE twin, row 3's)
NARROW_EVAL = (("0", "resnetfc_fwd_gather_code"), ("0 1 2", "resnetfc_fwd_dense_mv_code"))


def forward_check(tw, tables, code_arrays, gen, case, records, code_records, smi, label,
                  twin=None, plain_twin=None) -> None:
    """Rows 1-4 and their CODE twins (row 6) of the tower ``tw`` (sn64's:
    the latent in blocks 0-2, the views' mean at block 3; any width H and
    latent C the kernels take) on (NS, T, C) ``tables`` at one shape
    ``case`` = (kind, NS, SB, B): each against its plain version at the bar
    of 3 (max|d| <= 0.015 max(1, max|ref|), corr > 0.999), one launch,
    bit-identical on a second call, the gathers bit for bit the dense
    kernels on their bf16 latent; with ``twin`` = (its name, the record key
    under which the times are kept, e.g. ("d_hidden 512", ("narrow",
    "h384"), "h512"), its tower, its tables), timed in turns beside it (the
    twin, this, this, the twin) with their plain, cuBLAS and bound times;
    or a list of such twins, each timed in turns beside it (a native width
    beside d_hidden 512 and beside itself zero-padded to the next library's
    width); with ``plain_twin`` (a zero-padded ``tw``'s own tower,
    unpadded) also beside that tower's plain version in turns (the plain
    version, this, this, the plain version).  A padded tower's FLOP and
    bound are its own width's (``tw.d_hidden``).  Logs a line a variant and
    exits on a failure."""
    from pixelnerf_tpu_torch.ops import resnetfc_fused as rf
    from pixelnerf_tpu_torch.ops.grid_sample import bilinear_taps
    from pixelnerf_tpu_torch.ops.replay import agree

    kind, NS, sb, B = case
    twins = [] if twin is None else [twin] if isinstance(twin[0], str) else list(twin)
    dev = tables.device
    H, (n_lin_z, C) = tw.w_in.shape[1], tw.w_z.shape[:2]
    Hw = tw.d_hidden  # the tower's own width: below H when zero-padded onto H's library
    width = f"d_hidden {Hw}" + (f" (zero-padded onto the {H} library)" if Hw != H else "")
    nb, cl, d_in, d_out = tw.w_blk.shape[0], 3, tw.d_in, tw.w_out.shape[1]
    T = tables.shape[1]
    side = int(math.isqrt(T))
    rows = NS * sb * B if NS > 1 else B
    B_out = sb * B
    pts = torch.rand(rows, 3, device=dev, generator=gen) * 2 - 1
    vd = torch.nn.functional.normalize(torch.randn(rows, 3, device=dev, generator=gen), dim=-1)
    rc = rf.RawCode(torch.cat([pts, vd], dim=-1).contiguous(), *code_arrays)
    x = rf.materialize_code(rc._replace(cd=torch.float32)).contiguous()
    idx, w = bilinear_taps(torch.rand(rows, 2, device=dev, generator=gen) * 2 - 1, side, side,
                           pad_taps_to=8)
    idx[0::32, 0] = -1  # taps outside the table contribute nothing
    idx[16::32, 3] = T
    idx, w = idx.contiguous(), w.contiguous()
    gather = kind.startswith("gather")
    name = "resnetfc_fwd_" + kind
    shape = f"NS {NS}" + (f" x SB {sb}" if sb > 1 else "") + f" x {B} = {B_out} output points"

    def lookup(tabs):
        return (mv_latent(tabs, idx, w, sb) if NS > 1
                else rf.gather_reference(idx, w, tabs[0], torch.bfloat16).to(torch.bfloat16))

    def call(t, tabs, z, xi):
        if kind == "gather":
            return rf.resnetfc_gather(idx, w, tabs[0], xi, t, nb)
        if kind == "dense":
            return rf.resnetfc_dense(z, xi, t, nb)
        if kind == "gather_mv":
            return rf.resnetfc_gather_mv(idx, w, tabs, xi, t, nb, cl)
        return rf.resnetfc_dense_mv(z, xi, t, nb, NS, cl, sb)

    tabs = tables[:NS].contiguous()
    with torch.no_grad():
        z = lookup(tabs)
        for variant, xi in ((name, x), (name + "_code", rc)):
            before = dict(rf.LAUNCHES)
            out = call(tw, tabs, z, xi)
            torch.cuda.synchronize()
            launched = {k: v - before[k] for k, v in rf.LAUNCHES.items() if v != before[k]}

            def plain(xi=xi):
                return rf.resnetfc_reference(z, xi, tw, nb, compute_dtype=torch.bfloat16, NS=NS,
                                             sb=sb, combine_layer=cl if NS > 1 else None)

            ref = plain()
            d, bar, corr = agree(out, ref)
            del ref
            identical = torch.equal(out, call(tw, tabs, z, xi))
            same = None
            if gather:  # the dense kernels on gather_reference's bf16 latent
                same = torch.equal(out, rf.resnetfc_dense(z, xi, tw, nb) if NS == 1
                                   else rf.resnetfc_dense_mv(z, xi, tw, nb, NS, cl, 1))
            ok = (d <= bar and corr > 0.999 and bool(torch.isfinite(out).all()) and identical
                  and out.shape == (d_out, B_out) and launched == {variant: 1}
                  and same is not False)
            line = (f"{label}: {variant} at {width}, C = {C} ({rf.latent_pieces(C)} "
                    f"piece{'s' if C > rf.TILE_K else ''} an injection), {shape}: max|d| {d:.6g} "
                    f"(bar {bar:.6g}), corr {corr:.7f}, bit-identical second call {identical}, "
                    f"launches {launched}"
                    + (f", bit-identical to the dense kernel on its bf16 latent {same}"
                       if gather else ""))
            rec = records[variant] if variant in records else code_records[variant]
            rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), d)
            if twins:
                ms_turns = []
                for twin_name, (section, key), twin_key, tw2, tables2 in twins:
                    tabs2 = tables2[:NS].contiguous()
                    z2 = lookup(tabs2)
                    t = {"twin": [], "this": []}
                    for which in ("twin", "this", "this", "twin"):
                        t[which].append(cuda_ms(lambda: call(tw2, tabs2, z2, xi) if which == "twin"
                                                else call(tw, tabs, z, xi), 3))
                    del z2
                    ms_turns.append(tuple(sum(t[k]) / 2 for k in ("this", "twin")))
                ms = sum(m for m, _ in ms_turns) / len(ms_turns)
                plain_ms = cuda_ms(plain, 2)
                xl = rf.materialize_code(rc) if xi is rc else x
                b16 = torch.bfloat16
                if gather:  # the lookup in torch, a tap at a time (rows clamped)
                    i4 = idx[:, :4].long().clamp(0, T - 1)
                    if NS > 1:
                        views = torch.arange(NS, device=dev)[:, None]
                        i4, w4 = i4.reshape(NS, B, 4), w[:, :4].reshape(NS, B, 4)

                    def zl():
                        if NS > 1:
                            return sum(tabs[views, i4[..., j]] * w4[..., j, None].to(b16)
                                       for j in range(4))
                        return sum(tabs[0][i4[:, j]] * w[:, j, None].to(b16) for j in range(4))
                else:
                    zv = z if NS == 1 else by_view(z, NS, sb)

                    def zl():
                        return zv
                if NS == 1:
                    library_ms = cuda_ms(lambda: library_tower(zl(), xl, tw, nb), 3)
                else:
                    xv = by_view(xl, NS, sb)
                    library_ms = cuda_ms(lambda: library_tower_mv(zl(), xv, tw, nb, NS, cl), 3)
                raw_d = rc.x.shape[1]
                coded = xi is rc
                w_bytes = sum(tt.numel() * tt.element_size() for tt in tw[:8])
                x_bytes = rows * (raw_d if coded else d_in) * 4
                lat_bytes = (rows * (idx.shape[1] + w.shape[1]) * 4 + NS * T * C * 2
                             if gather else rows * C * 2)
                pre = cl if NS > 1 else nb  # blocks each view runs on its own
                flops = B_out * 2 * Hw * (NS * (d_in + n_lin_z * C + 2 * pre * Hw)
                                          + 2 * (nb - pre) * Hw + d_out)
                extra = (rows * 2 * raw_d * d_in if coded else 0) + (rows * 8 * C if gather else 0)
                b_ms, b_by = bound(flops + extra, x_bytes + lat_bytes + B_out * d_out * 4 + w_bytes)
                for (twin_name, (section, key), twin_key, _, _), (ms1, ms2) in zip(twins, ms_turns):
                    line += (f"; in turns ({twin_name}, this, this, {twin_name}) {ms1:.4f} ms "
                             f"beside {twin_name}'s {ms2:.4f} ({ms1 / ms2:.4f}x)")
                    rec.setdefault(section, {})[key] = {
                        "ms": ms1, f"{twin_key}_ms_in_turns": ms2, "plain_ms": plain_ms,
                        "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
                        "tflops": flops / ms1 / 1e9, "share_of_bound": b_ms / ms1,
                        "points": B_out, "views": NS, "max_abs_err": d, "corr": corr}
                if plain_twin is not None:
                    t = {"plain": [], "this": []}
                    for which in ("plain", "this", "this", "plain"):
                        t[which].append(cuda_ms(
                            lambda: rf.resnetfc_reference(
                                z, xi, plain_twin, nb, compute_dtype=torch.bfloat16, NS=NS, sb=sb,
                                combine_layer=cl if NS > 1 else None) if which == "plain"
                            else call(tw, tabs, z, xi), 2))
                    ms1, ms2 = (sum(t[k]) / 2 for k in ("this", "plain"))
                    line += (f"; in turns beside its own unpadded plain version (d_hidden "
                             f"{plain_twin.d_hidden}) {ms1:.4f} ms beside {ms2:.4f} "
                             f"({ms1 / ms2:.4f}x)")
                    rec[twins[0][1][0]][twins[0][1][1]].update(
                        ms_beside_unpadded_plain=ms1, unpadded_plain_ms_in_turns=ms2)
                line += (f"; {flops / ms / 1e9:.1f} TFLOP/s, {b_ms / ms:.3f} of the bound; "
                         f"plain_ms {plain_ms:.4f}; library_ms {library_ms:.4f} (cuBLAS bf16 "
                         f"chain{', the lookup in torch' if gather else ''}); bound_ms "
                         f"{b_ms:.4f} ({b_by})")
            log(line + f"; on {smi}")
            if not ok:
                raise SystemExit(f"{label}: {variant} at {width}, C = {C}, {shape} "
                                 "disagrees with its plain version or missed its launch")
            del out
        del z


def narrow_conf(base, H: int, n_blocks: int = 5):
    """sn64's conf (``base``) with both heads' d_hidden set to H (and their
    blocks to ``n_blocks``), built in code as ``option_confs`` builds its
    confs: sn64's other widths (latent C = 512 in blocks 0-2, the views'
    mean at block 3, the 6-frequency code, d_out 4)."""
    import copy

    c = copy.deepcopy(base)
    for head in ("mlp_coarse", "mlp_fine"):
        c.put(f"model.{head}.d_hidden", H)
        c.put(f"model.{head}.n_blocks", n_blocks)
    return c


# frame 0's routes: the dense route (no fused gather), the deferred code
FRAME_DENSE = {"PIXELNERF_FUSED_GATHER_MAX_ROWS": "0"}
FRAME_CODE = {"PIXELNERF_DEFER_CODE": "1"}


def frame_routes(src, src3):
    """Frame 0's routes, (source, views, env, the kernel its render must
    launch): the fused gather (NS 1), the dense route, the multi-view gather
    (NS 2) and the multi-view dense kernel (NS 3), then each with the
    deferred code."""
    routes = [(src, (0,), {}, "resnetfc_fwd_gather"),
              (src, (0,), FRAME_DENSE, "resnetfc_fwd_dense"),
              (src3, (0, 1), {}, "resnetfc_fwd_gather_mv"),
              (src3, (0, 1, 2), {}, "resnetfc_fwd_dense_mv")]
    return routes + [(s, v, dict(e, **FRAME_CODE), k + "_code") for s, v, e, k in routes]


def render_frame0(model, c, s, views, env, rays, dev):
    """Frame 0 of ``model`` (conf ``c``) from source ``s``'s ``views`` under
    the environment ``env``: (the frame, its seconds, the forward kernels'
    launches)."""
    from pixelnerf_tpu_torch import entry
    from pixelnerf_tpu_torch.ops import resnetfc_fused as rf

    restore = _env(env)
    try:
        rf.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _ = entry.render_ring(model, c, s, rays, torch.Generator(device=dev).manual_seed(SEED),
                                   RAYS_PER_STEP, views=views)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, {k: v for k, v in rf.LAUNCHES.items() if v}
    finally:
        restore()


def route_label(views, env) -> str:
    return (f"views {list(views)}" + (", dense route" if FRAME_DENSE.keys() & env.keys() else "")
            + (", deferred code" if FRAME_CODE.keys() & env.keys() else ""))


def width_label(H: int) -> str:
    """A width, and the library a padded width is packed onto."""
    from pixelnerf_tpu_torch.ops import resnetfc_fused as rf

    L = rf.library_width(H)
    return f"{H}" + (f" (on the {L} library, zero-padded)" if L != H else "")


def live_heads(conf, c, dev):
    """sn64's model at conf ``c`` on the kernel route (``auto``) and the
    plain route (``torch``), the same seeded weights, every block live (fc_1
    ~ N(0, 0.02^2)), as the render phases' model."""
    from pixelnerf_tpu_torch import entry

    models = {impl: entry.build_model(c, dev, mlp_impl=impl, seed=SEED) for impl in ("auto", "torch")}
    g = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        for mlp in (models["auto"].mlp_coarse, models["auto"].mlp_fine):
            for blk in mlp.blocks:
                blk.fc_1.weight.copy_(0.02 * torch.randn(blk.fc_1.weight.shape, generator=g))
    models["torch"].load_state_dict(models["auto"].state_dict())
    return models


# A kernel frame's reading against the plain f32 route may fall this far
# below what bf16 alone reads there (the most seen: 0.055 dB, at d_hidden
# 1024), where bf16 alone misses 40 dB (frame_gate)
FRAME_ALONE_SLACK_DB = 0.5


class bf16_alone:
    """Within it, the four forward wrappers of ``resnetfc_fused`` compute
    their plain versions at bf16 operands (as ``forward_check``'s plain
    version: the latent looked up and rounded to bf16, then
    ``resnetfc_reference`` at ``compute_dtype=bf16``) on the card, launching
    nothing: the kernels' rounding without the kernels."""

    def __enter__(self):
        from pixelnerf_tpu_torch.ops import resnetfc_fused as rf

        b16 = torch.bfloat16
        self.rf = rf
        self.saved = {n: getattr(rf, n) for n in ("resnetfc_dense", "resnetfc_gather",
                                                 "resnetfc_dense_mv", "resnetfc_gather_mv")}
        rf.resnetfc_dense = lambda z, x, t, nb, planar_out=True: rf.resnetfc_reference(
            z, x, t, nb, planar_out, compute_dtype=b16)
        rf.resnetfc_gather = lambda idx, w, table, x, t, nb, planar_out=True: (
            rf.resnetfc_reference(rf.gather_reference(idx, w, table, b16), x, t, nb, planar_out,
                                  compute_dtype=b16))
        rf.resnetfc_dense_mv = lambda z, x, t, nb, NS, cl, sb=1, planar_out=True: (
            rf.resnetfc_reference(z, x, t, nb, planar_out, compute_dtype=b16, NS=NS, sb=sb,
                                  combine_layer=cl))
        rf.resnetfc_gather_mv = lambda idx, w, tables, x, t, nb, cl, planar_out=True: (
            rf.resnetfc_reference(rf.gather_reference(idx, w, tables, b16), x, t, nb,
                                  planar_out, compute_dtype=b16, NS=tables.shape[0],
                                  combine_layer=cl))
        return self

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(self.rf, n, f)


def frame_gate(p: float, p_alone: float, p_kernel: float) -> bool:
    """Whether a kernel frame reading ``p`` dB against the plain f32 route
    passes: >= 40 dB; or, where bf16 alone (the kernels' plain versions on
    the same weights) reads ``p_alone`` < 40 dB there -- a reading no bf16
    tower can reach on these weights -- the kernel frame ``p_kernel`` >= 40
    dB against the bf16-alone frame and ``p`` no more than
    FRAME_ALONE_SLACK_DB below ``p_alone``."""
    return p >= 40.0 or (p_alone < 40.0 and p_kernel >= 40.0
                         and p >= p_alone - FRAME_ALONE_SLACK_DB)


def frames_on_every_route(H, c, models, routes, rays, dev, smi, launches, tag) -> None:
    """Frame 0 of the d_hidden H model on every route of ``routes``, each
    view set's scene shaped first so that the plain frame shows the object
    (show_object): the kernel route launching its kernel only, against the
    plain f32 route and against bf16 alone at ``frame_gate``, not blank;
    the launches kept in ``launches`` by kernel.  Exits on a failure."""
    for s0, views0 in {(id(s), v): (s, v) for s, v, _, _ in routes}.values():
        # each head's density shaped on this view set's scene, so that its
        # plain frame 0 shows the object: a blank frame is the same on both
        # routes whatever the kernels
        keep = show_object(models, s0, views0, rays,
                           lambda m: render_frame0(m, c, s0, views0, {}, rays, dev)[0])
        for s, views, env, kname in routes:
            if s is not s0 or views != views0:
                continue
            ref, _, la_ref = render_frame0(models["torch"], c, s, views, env, rays, dev)
            out, _, la = render_frame0(models["auto"], c, s, views, env, rays, dev)
            with bf16_alone():
                alone = render_frame0(models["auto"], c, s, views, env, rays, dev)[0]
            p, fg = psnr(out, ref), foreground(out)
            p_alone, p_kernel = psnr(alone, ref), psnr(out, alone)
            ok = (set(la) == {kname} and not la_ref and bool(torch.isfinite(out).all())
                  and frame_gate(p, p_alone, p_kernel) and fg > 0)
            label = route_label(views, env)
            launches.setdefault(kname, {})[f"d_hidden {H}, frame 0, {label}"] = la.get(kname, 0)
            log(f"{tag} render: d_hidden {width_label(H)}, {label}: launches {la} (want "
                f"{kname}); vs the plain f32 route {p:.3f} dB (need >= 40, or where bf16 alone "
                f"reads below 40: >= 40 against bf16 alone and within {FRAME_ALONE_SLACK_DB} dB "
                f"of its reading); bf16 alone (the kernels' plain versions) vs the plain f32 "
                f"route {p_alone:.3f} dB; vs bf16 alone {p_kernel:.3f} dB; foreground "
                f"{fg:.4f} (need > 0; the density shaped on these views to occupy "
                f"{keep:.3g} of frame 0's points); on {smi}")
            if not ok:
                raise SystemExit(f"{tag} render at d_hidden {H}, {label} missed {kname}, "
                                 "disagrees with the plain route or is blank")


def frame0_beside_512(H, c, model, net, conf, routes, rays, dev, smi, tag) -> None:
    """Frame 0 rays/s of the d_hidden H model on each route beside sn64's
    (d_hidden 512) ``net``, in turns (512, H, H, 512)."""
    for s, views, env, kname in routes:
        t = {512: [], H: []}
        for h in (512, H, H, 512):
            m, cc = (net, conf) if h == 512 else (model, c)
            t[h].append(render_frame0(m, cc, s, views, env, rays, dev)[1])
        s512, sH = (sum(t[h]) / 2 for h in (512, H))
        log(f"{tag} render: d_hidden {width_label(H)}, {route_label(views, env)}: frame 0 (encode "
            f"included) {sH:.4f} s = {RAYS_PER_STEP / sH:.1f} rays/s beside d_hidden 512's "
            f"{s512:.4f} s = {RAYS_PER_STEP / s512:.1f} rays/s in turns ({s512 / sH:.3f}x); "
            f"runs {json.dumps({str(k): v for k, v in t.items()})}; on {smi}")


def narrow_phase(conf, net, src, src3, rays, dev, smi, records, code_records, nmr_root) -> None:
    """Phase 17: sn64's conf at d_hidden 384, 256, 128 and 64, 320 and
    192, and 200 (zero-padded onto the 256 library) on the forward kernels'
    narrower libraries (see the module docstring); ``net`` is the render
    phases' sn64 model (d_hidden 512), timed beside them in turns, and 320
    and 192 are also timed beside themselves zero-padded onto the next
    library."""
    import types

    from pixelnerf_tpu_torch.eval.eval import main as eval_main
    from pixelnerf_tpu_torch.ops import resnetfc_fused as rf
    from pixelnerf_tpu_torch.ops.replay import KernelCalls
    from pixelnerf_tpu_torch.train import checkpoints

    t_phase = time.perf_counter()
    rays = rays[:RAYS_PER_STEP]  # ring frame 0, as the other phases render it
    code = FRAME_CODE
    routes = frame_routes(src, src3)

    # ---- frame 0 on every route at each width, against the plain route ----
    confs, models, narrow_launches = {}, {}, {}
    for H in NARROW_H + NEW_H:
        c = confs[H] = narrow_conf(conf, H)
        for impl, m in live_heads(conf, c, dev).items():
            models[H, impl] = m
    calls = KernelCalls()
    with calls:
        for H in NARROW_H + NEW_H:
            frames_on_every_route(H, confs[H], {"auto": models[H, "auto"],
                                                "torch": models[H, "torch"]},
                                  routes, rays, dev, smi, narrow_launches, "narrow")
    replayed(calls.check(), "narrow")
    del calls

    # ---- frame 0 rays/s beside d_hidden 512, in turns (512, H, H, 512); the
    # new widths on the encoded code's routes only ----
    for H in NARROW_H + NEW_H:
        frame0_beside_512(H, confs[H], models[H, "auto"], net, conf,
                          routes if H in NARROW_H else routes[:4], rays, dev, smi, "narrow")

    # ---- every forward kernel and twin: the fine pass and a ragged B ----
    gi = torch.Generator(device=dev).manual_seed(SEED + 17)
    tw512 = net.mlp_fine.tower(dev)
    fine = RAYS_PER_STEP * 96
    for H in NARROW_H + NEW_H:
        m = models[H, "auto"]
        mf = m.mlp_fine
        tw = mf.tower(dev)
        padded = None
        if H in NATIVE_H:  # the same tower zero-padded onto the next library
            L = rf.BWD_HIDDEN[rf.BWD_HIDDEN.index(H) + 1]
            padded = padded_twin(mf, L, dev)
        code_arrays = tuple(torch.from_numpy(a).to(dev) for a in m.code.flat_arrays(tail=3))
        with torch.no_grad():
            scene3 = m.encode(torch.as_tensor(src3["images"], device=dev),
                              torch.as_tensor(src3["poses"], device=dev), float(src3["focal"]))
        tables3 = scene3.latents.reshape(3, -1, m.d_latent).to(torch.bfloat16).contiguous()
        for case in (("gather", 1, 1, fine), ("gather", 1, 1, 2000), ("dense", 1, 1, fine),
                     ("dense", 1, 1, 2000), ("gather_mv", 2, 1, fine), ("gather_mv", 3, 1, 333),
                     ("dense_mv", 3, 1, fine), ("dense_mv", 3, 2, 333)):
            twin = None
            if case[3] == fine:
                twin = [("d_hidden 512", ("narrow", f"h{H}"), "h512", tw512, tables3)]
                if padded is not None:
                    twin.append((f"itself padded to {L}", ("narrow", f"h{H}_vs_padded"),
                                 f"padded{L}", padded, tables3))
            forward_check(tw, tables3, code_arrays, gi, case, records, code_records, smi,
                          "narrow kernel check", twin)
        del scene3, tables3, padded

    # ---- the eval CLI at d_hidden 256, deferred code, on the NMR fixture ----
    H = 256  # NARROW_EVAL's width
    restore = _env({"PIXELNERF_ALLOW_RANDOM_BACKBONE": "1", **code})  # no backbone weights here
    try:
        with tempfile.TemporaryDirectory() as tmp:
            ck = os.path.join(tmp, "ck")
            checkpoints.save_weights(types.SimpleNamespace(checkpoints_path=ck, name="narrow"),
                                     models[H, "auto"])
            cpath = os.path.join(tmp, "narrow.conf")
            with open(cpath, "w") as fh:  # sn64's conf with the narrow heads, as a file says it
                fh.write(f'include required("{os.path.abspath("conf/exp/sn64.conf")}")\n'
                         f"model {{ mlp_coarse {{ d_hidden = {H} }}\n"
                         f"        mlp_fine {{ d_hidden = {H} }} }}\n")
            for source, want in NARROW_EVAL:
                out_dir = os.path.join(tmp, "eval" + source.replace(" ", ""))
                argv = ["-n", "narrow", "-c", cpath, "-F", "dvr", "-D", nmr_root, "--split",
                        "test", "-P", source, "--max_objs", "1", "-O", out_dir,
                        "--checkpoints_path", ck, "-R", str(EVAL_RAYS)]
                torch.cuda.synchronize()
                rf.reset_launches()
                t0 = time.perf_counter()
                res = eval_main(argv)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                la = {k: v for k, v in rf.LAUNCHES.items() if v}
                n_rays = (NMR_VIEWS - len(source.split())) * FRAME * FRAME
                ok = (res["cnt"] == 1 and len(res["objects"]) == 1
                      and all(math.isfinite(v) for _, p_, s_ in res["objects"] for v in (p_, s_))
                      and set(la) == {want})
                log(f"narrow eval: python -m pixelnerf_tpu_torch.eval.eval -c conf/exp/sn64.conf "
                    f"+ d_hidden {H} -F dvr --split test -P \"{source}\" with "
                    f"PIXELNERF_DEFER_CODE=1: {[(n, round(p_, 4), round(s_, 4)) for n, p_, s_ in res['objects']]}; "
                    f"launches {la} (want {want}); {dt:.3f} s wall, {n_rays} rays = "
                    f"{n_rays / dt:.1f} rays/s (model build and load included); on {smi}")
                if not ok:
                    raise SystemExit(f"narrow eval -P {source!r} failed or did not run through "
                                     f"{want}")
                narrow_launches.setdefault(want, {})[f"d_hidden {H}, eval -P \"{source}\""] = la[want]
    finally:
        restore()
    for name, by_path in narrow_launches.items():
        (records[name] if name in records else code_records[name])["narrow_launches"] = by_path
    del models
    log(f"narrow: phase done in {time.perf_counter() - t_phase:.1f} s")


# phase 17's wide part: the forward kernels' d_hidden 1024 library (a
# 64-point tile on a cluster of two CTAs) at its own width and a width
# zero-padded onto it
WIDE_H = 1024
WIDE_PADDED_H = 640


def unpadded_tower(tw):
    """A zero-padded tower at its own width: the padded weights sliced off."""
    from pixelnerf_tpu_torch.ops import resnetfc_fused as rf

    H = tw.d_hidden
    return rf.Tower(tw.w_in[:, :H], tw.b_in[:H], tw.w_z[..., :H], tw.b_z[:, :H],
                    tw.w_blk[:, :, :H, :H], tw.b_blk[:, :, :H], tw.w_out[:H], tw.b_out,
                    tw.d_in, H)


def wide_phase(conf, net, src, src3, rays, dev, smi, records, code_records, nmr_root) -> None:
    """Phase 17's wide part: sn64's conf at d_hidden 1024 and 640 (zero-padded
    onto the 1024 library), both heads (``narrow_conf``): frame 0 against
    the plain f32 route and bf16 alone (``frame_gate``, showing the object, the width's
    launches, the calls replayed) on every route and CODE twin at 1024, on
    the encoded routes at 640, and at 1024 beside ``net`` (d_hidden 512) in
    turns on the encoded routes; rows 1-4 and their CODE twins at the
    render's fine pass (and at 1024 a ragged B) against their plain
    versions (``forward_check``: one launch, bit-identical second calls, the
    gathers bit for bit the dense kernels), timed at the fine pass beside
    d_hidden 512 in turns, 640 also beside its own unpadded plain version;
    ``eval -P "0"`` at 1024 on the NMR fixture on the kernels; one train CLI
    step at -V 1 at 1024, on the plain field (no backward library past
    512): no backward-kernel launch."""
    import types

    from pixelnerf_tpu_torch.eval.eval import main as eval_main
    from pixelnerf_tpu_torch.ops import resnetfc_fused as rf
    from pixelnerf_tpu_torch.ops import resnetfc_vjp as rv
    from pixelnerf_tpu_torch.ops.replay import KernelCalls
    from pixelnerf_tpu_torch.train import checkpoints
    from pixelnerf_tpu_torch.train import main as train_main

    t_phase = time.perf_counter()
    rays = rays[:RAYS_PER_STEP]
    routes = frame_routes(src, src3)
    widths = (WIDE_H, WIDE_PADDED_H)
    confs = {H: narrow_conf(conf, H) for H in widths}
    models = {H: live_heads(conf, confs[H], dev) for H in widths}
    launches = {}
    calls = KernelCalls()
    with calls:
        for H in widths:
            frames_on_every_route(H, confs[H], models[H], routes if H == WIDE_H else routes[:4],
                                  rays, dev, smi, launches, "wide")
    replayed(calls.check(), "wide")
    del calls
    frame0_beside_512(WIDE_H, confs[WIDE_H], models[WIDE_H]["auto"], net, conf, routes[:4], rays,
                      dev, smi, "wide")

    # ---- every forward kernel and twin: the fine pass and a ragged B ----
    gi = torch.Generator(device=dev).manual_seed(SEED + 27)
    tw512 = net.mlp_fine.tower(dev)
    fine = RAYS_PER_STEP * 96
    for H in widths:
        m = models[H]["auto"]
        tw = m.mlp_fine.tower(dev)
        code_arrays = tuple(torch.from_numpy(a).to(dev) for a in m.code.flat_arrays(tail=3))
        with torch.no_grad():
            scene3 = m.encode(torch.as_tensor(src3["images"], device=dev),
                              torch.as_tensor(src3["poses"], device=dev), float(src3["focal"]))
        tables3 = scene3.latents.reshape(3, -1, m.d_latent).to(torch.bfloat16).contiguous()
        cases = [("gather", 1, 1, fine), ("dense", 1, 1, fine), ("gather_mv", 2, 1, fine),
                 ("dense_mv", 3, 1, fine)]
        if H == WIDE_H:  # a ragged last tile at each kernel
            cases += [("gather", 1, 1, 2000), ("dense", 1, 1, 2000), ("gather_mv", 3, 1, 333),
                      ("dense_mv", 3, 2, 333)]
        for case in cases:
            twin = plain_twin = None
            if case[3] == fine:
                twin = ("d_hidden 512", ("wide", f"h{H}"), "h512", tw512, tables3)
                if H != WIDE_H:
                    plain_twin = unpadded_tower(tw)
            forward_check(tw, tables3, code_arrays, gi, case, records, code_records, smi,
                          "wide kernel check", twin, plain_twin)
        del scene3, tables3

    # ---- the eval CLI at d_hidden 1024 on the NMR fixture; one train CLI
    # step at -V 1, on the plain field ----
    restore = _env({"PIXELNERF_ALLOW_RANDOM_BACKBONE": "1"})  # no backbone weights here
    try:
        with tempfile.TemporaryDirectory() as tmp:
            ck = os.path.join(tmp, "ck")
            checkpoints.save_weights(types.SimpleNamespace(checkpoints_path=ck, name="wide"),
                                     models[WIDE_H]["auto"])
            cpath = os.path.join(tmp, "wide.conf")
            with open(cpath, "w") as fh:  # sn64's conf with the wide heads, as a file says it
                fh.write(f'include required("{os.path.abspath("conf/exp/sn64.conf")}")\n'
                         f"model {{ mlp_coarse {{ d_hidden = {WIDE_H} }}\n"
                         f"        mlp_fine {{ d_hidden = {WIDE_H} }} }}\n")
            want = "resnetfc_fwd_gather"
            torch.cuda.synchronize()
            rf.reset_launches()
            t0 = time.perf_counter()
            res = eval_main(["-n", "wide", "-c", cpath, "-F", "dvr", "-D", nmr_root, "--split",
                             "test", "-P", "0", "--max_objs", "1", "-O",
                             os.path.join(tmp, "eval"), "--checkpoints_path", ck, "-R",
                             str(EVAL_RAYS)])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            la = {k: v for k, v in rf.LAUNCHES.items() if v}
            n_rays = (NMR_VIEWS - 1) * FRAME * FRAME
            ok = (res["cnt"] == 1 and len(res["objects"]) == 1
                  and all(math.isfinite(v) for _, p_, s_ in res["objects"] for v in (p_, s_))
                  and set(la) == {want})
            log(f"wide eval: python -m pixelnerf_tpu_torch.eval.eval -c conf/exp/sn64.conf + "
                f"d_hidden {WIDE_H} -F dvr --split test -P \"0\": "
                f"{[(n, round(p_, 4), round(s_, 4)) for n, p_, s_ in res['objects']]}; launches "
                f"{la} (want {want}); {dt:.3f} s wall, {n_rays} rays = {n_rays / dt:.1f} rays/s "
                f"(model build and load included); on {smi}")
            if not ok:
                raise SystemExit(f"wide eval -P '0' failed or did not run through {want}")
            launches.setdefault(want, {})[f"d_hidden {WIDE_H}, eval -P \"0\""] = la[want]

            rf.reset_launches()
            rv.reset_launches()
            t0 = time.perf_counter()
            trainer = train_main(["-n", "wide_train", "-c", cpath, "-F", "dvr", "-D", nmr_root,
                                  "-B", "4", "-V", "1", "-R", "128", "--epochs", "1",
                                  "--checkpoints_path", os.path.join(tmp, "ck_train")])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            la = {k: v for k, v in dict(rf.LAUNCHES, **rv.LAUNCHES).items() if v}
            ok = (trainer.global_step == 1 and all(math.isfinite(v) for v in trainer.history)
                  and not any(k.startswith("resnetfc_bwd") for k in la)
                  and not trainer.net.field_backward_in_kernel(1)
                  and all(mm.d_hidden == WIDE_H
                          for mm in (trainer.net.mlp_coarse, trainer.net.mlp_fine)))
            log(f"wide train path: python -m pixelnerf_tpu_torch.train -c conf/exp/sn64.conf + "
                f"d_hidden {WIDE_H} -F dvr -B 4 -V 1 -R 128, one step: {trainer.global_step} "
                f"step in {wall:.3f} s (build and validation included); remat {trainer.remat}; "
                f"launches {la} (want no resnetfc_bwd_*: the field trains plain past 512; the "
                f"forward kernels only in the validation render); losses "
                f"{[round(v, 5) for v in trainer.history]}; on {smi}")
            if not ok:
                raise SystemExit("wide: the d_hidden 1024 train step failed or reached a "
                                 "backward kernel")
            del trainer
    finally:
        restore()
    for name, by_path in launches.items():
        (records[name] if name in records else code_records[name]).setdefault(
            "wide_launches", {}).update(by_path)
    del models
    log(f"wide: phase done in {time.perf_counter() - t_phase:.1f} s")


# phase 18: rows 5a / 5b at the narrower widths (d_hidden 384, 256, 128 and
# 64; 320 and 192; 200, zero-padded onto the 256 library) and past 5
# blocks
# the gates' shapes (NS, SB, B_obj): a ragged B from 1 and 3 views (the last
# 64-point tile half full) and the train step's fine pass (4 x 12,288)
NARROW_BWD_SHAPES = ((1, 2, 1000), (3, 2, 333), (1, 4, 128 * 96), (3, 4, 128 * 96))
# the latent widths past sn64's that d_hidden 128 and 384 are also gated at,
# on the ragged shapes: the global encoder's 640 (2 pieces, 5 dz steps an
# injection at 128, 2 at 384) and the ConvEncoder's 128
NARROW_BWD_C = (640, 128)
# the deep towers: sn64's past 5 blocks, to the deepest the route rule
# trains on the kernels (resnetfc_vjp.GRAD_MAX_BLOCKS), through the gate with
# the planted faults on a 144-wide code (kin 144: all four faults apply)
DEEP_DEPTHS = (8, 16, 32)
# the wide codes at sn64's other widths (d_in 144 and 510: kin 144 and 512)
WIDE_CODES = (144, 510)
# the train CLI's runs: (what, the conf's model keys, d_hidden, n_blocks,
# the code's width d_in, -V, -F, steps); sn64's code is 42 wide, 11
# frequencies over (xyz, viewdir) make it 138 (kin 144)
CODE144 = "use_code_viewdirs = true\ncode { num_freqs = 11 }"
NARROW_TRAIN = tuple(
    (f"d_hidden {H}", f"mlp_coarse {{ d_hidden = {H} }}\nmlp_fine {{ d_hidden = {H} }}", H, 5, 42,
     nviews, fmt, 3)
    for H in (384, 256, 64) for nviews, fmt in ((1, "dvr"), (3, "dvr_dtu"))) + tuple(
    (f"d_hidden {H}", f"mlp_coarse {{ d_hidden = {H} }}\nmlp_fine {{ d_hidden = {H} }}", H, 5, 42,
     nviews, fmt, 2)
    for H, nviews, fmt in ((320, 1, "dvr"), (192, 3, "dvr_dtu"), (PADDED_H, 1, "dvr"))) + tuple(
    (what, keys, 512, nb, d_in, nviews, fmt, 2)
    for what, keys, nb, d_in in (
        ("8 blocks", "mlp_coarse { n_blocks = 8 }\nmlp_fine { n_blocks = 8 }", 8, 42),
        ("a 138-wide code", CODE144, 5, 138))
    for nviews, fmt in ((1, "dvr"), (3, "dvr_dtu")))
# the train CLI at -V 1 on the kernels beside the same conf on the plain
# field (--mlp_impl torch: the route the parent took for these towers), in
# turns: (what, the model keys, steps a run)
TRAIN_TURNS = (("8 blocks", "mlp_coarse { n_blocks = 8 }\nmlp_fine { n_blocks = 8 }", 5),
               ("a 138-wide code", CODE144, 5))


def narrow_backward_phase(conf, dev, smi, records, nmr_root, dtu_root) -> None:
    """Phase 18: rows 5a / 5b on the narrower libraries, past 5 blocks and
    past a 128-wide code (see the module docstring): the gates at d_hidden
    384, 256, 128 and 64, 320 and 192 and 200 (zero-padded onto the 256
    library), at 8, 16 and 32 blocks with the planted faults and at kin 144
    and 512, the kernels' times at the train step's fine pass in turns
    beside d_hidden 512 (320 and 192 also beside themselves zero-padded onto
    the next library) and beside 5 blocks and kin 48, the train CLI at
    d_hidden 384, 256, 64, 320, 192 and 200, at 8 blocks and on a 138-wide
    code on the backward kernels (the last two also beside the plain field
    in turns), the train steps against the plain f32 step, and the widths,
    codes and depths outside the envelope kept plain."""
    from pixelnerf_tpu_torch.models.code import PositionalEncoding
    from pixelnerf_tpu_torch.models.resnetfc import ResnetFC
    from pixelnerf_tpu_torch.ops import resnetfc_fused as rf
    from pixelnerf_tpu_torch.ops import resnetfc_vjp as rv
    from pixelnerf_tpu_torch.train import main as train_main

    t_phase = time.perf_counter()
    nb, cl, d_out = 5, 3, 4
    code = PositionalEncoding.from_conf(conf["model.code"], d_in=3)
    d_in = code.d_out + 3
    gi = torch.Generator(device=dev).manual_seed(SEED + 18)
    names = ("resnetfc_bwd_data", "resnetfc_bwd_weights")
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mods = {(H, C): bwd_tower(C, d_in, dev, SEED + 18 + H + C, H)
            for H in (512,) + NARROW_H + NEW_H
            for C in (512,) + (NARROW_BWD_C if H in (128, 384) else ())}
    towers = {k: tw for k, (_, tw) in mods.items()}
    # each of those widths zero-padded onto the next library
    padded = {}
    for H in NATIVE_H:
        padded[H] = padded_twin(mods[H, 512][0], rf.BWD_HIDDEN[rf.BWD_HIDDEN.index(H) + 1], dev)
    del mods
    # the deep towers on a 144-wide code (the gates' planted faults all
    # apply) and sn64's widths on the wide codes
    if DEEP_DEPTHS[-1] != rv.GRAD_MAX_BLOCKS:
        raise SystemExit(f"the deep gates ({DEEP_DEPTHS}) must hold the route rule's deepest "
                         f"tower under grad ({rv.GRAD_MAX_BLOCKS})")
    deep = {nb_d: bwd_tower(512, 144, dev, SEED + 19 + nb_d, 512, nb_d)[1] for nb_d in DEEP_DEPTHS}
    wide = {d: bwd_tower(512, d, dev, SEED + 20 + d, 512, nb)[1] for d in WIDE_CODES}

    # ---- gates: C = 512 at each narrower width from 1 and 3 views, ragged
    # B and the train step's fine pass; C = 640 and 128 at d_hidden 128 and
    # 384 ----
    for (H, C), tw in towers.items():
        if H == 512:
            continue
        # the padded width on the ragged shapes: its library is 256's
        for NS, sb, B_obj in NARROW_BWD_SHAPES[: 4 if C == 512 and H != PADDED_H else 2]:
            x, z, g = bwd_inputs(code, gi, C, NS, sb, B_obj)
            backward_gate(tw, x, z, g, NS, sb, n_sms, records,
                          f"narrow backward check d_hidden {H}, C = {C} (sn64's depth)")
            del x, z, g
    # ---- the deep gates at sn64's widths, 8, 16 and 32 blocks (the deepest
    # the route trains, GRAD_MAX_BLOCKS), ragged B (8 blocks: the fine pass
    # too), each with the planted faults, which must fail; 8 blocks at the
    # narrower widths; the wide codes at sn64's depth, every shape ----
    for nb_d, tw in deep.items():
        for NS, sb, B_obj in NARROW_BWD_SHAPES[: 4 if nb_d == DEEP_DEPTHS[0] else 2]:
            x, z, g = bwd_inputs(wide_code(144), gi, 512, NS, sb, B_obj)
            backward_gate(tw, x, z, g, NS, sb, n_sms, records,
                          f"deep backward check: {nb_d} blocks at sn64's widths, kin 144",
                          faults=True)
            del x, z, g
    for H in NARROW_H + NATIVE_H:  # 8 blocks at each narrower library, ragged B
        tw = bwd_tower(512, d_in, dev, SEED + 19 + H, H, DEEP_DEPTHS[0])[1]
        for NS, sb, B_obj in NARROW_BWD_SHAPES[:2]:
            x, z, g = bwd_inputs(code, gi, 512, NS, sb, B_obj)
            backward_gate(tw, x, z, g, NS, sb, n_sms, records,
                          f"deep backward check: {DEEP_DEPTHS[0]} blocks at d_hidden {H}")
            del x, z, g
        del tw
    for d, tw in wide.items():
        for NS, sb, B_obj in NARROW_BWD_SHAPES:
            x, z, g = bwd_inputs(wide_code(d), gi, 512, NS, sb, B_obj)
            backward_gate(tw, x, z, g, NS, sb, n_sms, records,
                          f"wide code backward check: kin {tw.w_in.shape[0]} (d_in {d}) at "
                          f"sn64's widths")
            del x, z, g

    # ---- times at the train step's fine pass, d_hidden in turns beside 512 ----
    # every width, and each native one's padded twin ("<H>p")
    runs_w = {H: towers[H, 512] for H in (512,) + NARROW_H + NEW_H}
    runs_w.update({f"{H}p": tw for H, tw in padded.items()})
    widths = tuple(runs_w)
    for NS in (1, 3):
        sb, B_obj = 4, 128 * 96
        kw = dict(NS=NS, sb=sb, combine_layer=cl) if NS > 1 else {}
        B, rows = sb * B_obj, NS * sb * B_obj
        x, z, g = bwd_inputs(code, gi, 512, NS, sb, B_obj)  # the same inputs at every width
        data = {H: rv.bwd_data(g, z, x, runs_w[H], nb, False, **kw) for H in widths}
        t = {H: {n: [] for n in names} for H in widths}
        for H in widths + widths[::-1]:  # in turns
            tw, dH = runs_w[H], data[H]
            t[H][names[0]].append(cuda_ms(lambda: rv.bwd_data(g, z, x, tw, nb, False, **kw), 5))
            t[H][names[1]].append(cuda_ms(lambda: rv.bwd_weights(z, dH, tw, nb), 5))
        ms = {H: {n: sum(v) / len(v) for n, v in t[H].items()} for H in widths}
        for H in NARROW_H + NEW_H:
            tw, dH = towers[H, 512], data[H]
            (kin, Hl), L = tw.w_in.shape, f"{H}p"  # Hl: the library's width (256 at 200)
            plain, lib, bounds, flops = backward_yardsticks(tw, x, z, g, dH, NS, sb)
            # the weights kernel on the SM-filled splits and on the whole-view
            # splits (the split rule's choice before narrow towers), in turns
            # through the same launch
            lim = rv.kernel_limits(Hl)
            tasks = rv.weight_tasks(kin, Hl, 512, nb, 3, NS, dH.pre, B)
            plans = {"filled": rv.weight_plan(kin, Hl, 512, nb, 3, NS, dH.pre, B, lim, n_sms),
                     "whole": rv.weight_plan(kin, Hl, 512, nb, 3, NS, dH.pre, B, lim, n_sms,
                                             pts=rv.split_points(tasks, lim.max_splits))}
            split_ms = {k: [] for k in plans}
            for k in ("filled", "whole", "whole", "filled") * 2:
                split_ms[k].append(cuda_ms(lambda: rv._launch_weights(
                    z, dH, plans[k], kin, Hl, 512, nb, 3, d_out), 5))
            split_ms = {k: sum(v) / len(v) for k, v in split_ms.items()}
            filled, whole = plans["filled"], plans["whole"]
            for n in names:
                b_ms, b_by = bounds[n]
                extra = ""
                if n == names[1]:
                    ctas = sum(sp * rv.weight_tiles(tk, Hl, lim)
                               for sp, tk in zip(filled.table[4::6], tasks))
                    extra = (f"; {filled.tiles} output tiles in splits of {filled.pts} points "
                             f"({ctas} CTAs on {n_sms} SMs); in turns {split_ms['filled']:.4f} "
                             f"ms on these splits, {split_ms['whole']:.4f} on the whole-view "
                             f"splits of {whole.pts} points "
                             f"({split_ms['whole'] / split_ms['filled']:.3f}x)")
                log(f"narrow backward time: {n} at d_hidden {H}"
                    + (f" (zero-padded onto the {Hl} library)" if Hl != H else "")
                    + f", C = 512, -V {NS}, {B} output "
                    f"points{f' ({rows} rows)' if NS > 1 else ''}: in turns {ms[H][n]:.4f} ms "
                    f"beside {ms[512][n]:.4f} at d_hidden 512 ({ms[H][n] / ms[512][n]:.4f}x)"
                    + (f", {ms[128][n]:.4f} at d_hidden 128" if H == 256 else "")
                    + (f", {ms[L][n]:.4f} zero-padded onto the {padded[H].w_in.shape[1]} "
                       f"library ({ms[H][n] / ms[L][n]:.4f}x)" if L in ms else "")
                    + f"; {flops[n] / ms[H][n] / 1e9:.1f} TFLOP/s; "
                    f"plain_ms {plain[n]:.4f}; library_ms {lib[n]:.4f} ("
                    + ("autograd backward of the cuBLAS chain" if n == names[0]
                       else "cuBLAS bf16 A^T G a product")
                    + f"); bound_ms {b_ms:.4f} ({b_by}); {b_ms / ms[H][n]:.3f} of the bound"
                    + extra + f"; on {smi}")
                rec = dict(points=B, views=NS, ms=ms[H][n], h512_ms_in_turns=ms[512][n],
                           plain_ms=plain[n], library_ms=lib[n], bound_ms=b_ms, bound_by=b_by,
                           tflops=flops[n] / ms[H][n] / 1e9,
                           share_of_bound=b_ms / ms[H][n])
                if L in ms:
                    rec[f"padded{padded[H].w_in.shape[1]}_ms_in_turns"] = ms[L][n]
                if n == names[1]:
                    rec.update(pts=filled.pts, whole_view_pts=whole.pts,
                               filled_ms_in_turns=split_ms["filled"],
                               whole_view_ms_in_turns=split_ms["whole"])
                records[n].setdefault("narrow", {})[f"h{H}" + ("" if NS == 1 else f"_ns{NS}")] = rec
        del data, x, z, g
        # the deep towers (8, 16 and 32 blocks) and the
        # wide codes (kin 144, 512) beside sn64's tower (5 blocks, kin 48)
        # on the same points, latent and cotangent, in turns
        cases = {}
        for label, d, nb_c in ([("5 blocks, kin 48", d_in, nb)]
                               + [(f"{k} blocks", d_in, k) for k in DEEP_DEPTHS]
                               + [(f"kin {-(-k // 16) * 16}", k, nb) for k in WIDE_CODES]):
            tw = (towers[512, 512] if (d, nb_c) == (d_in, nb) else wide[d] if nb_c == nb
                  else bwd_tower(512, d, dev, SEED + 21 + nb_c, 512, nb_c)[1])
            x, z, g = bwd_inputs(wide_code(d), torch.Generator(device=dev).manual_seed(SEED + 31),
                                 512, NS, sb, B_obj)
            cases[label] = (tw, x, z, g, nb_c, rv.bwd_data(g, z, x, tw, nb_c, False, **kw))
        labels = tuple(cases)
        t = {k: {n: [] for n in names} for k in labels}
        for k in labels + labels[::-1]:  # in turns
            tw, x, z, g, nb_c, dk = cases[k]
            t[k][names[0]].append(cuda_ms(lambda: rv.bwd_data(g, z, x, tw, nb_c, False, **kw), 5))
            t[k][names[1]].append(cuda_ms(lambda: rv.bwd_weights(z, dk, tw, nb_c), 5))
        msd = {k: {n: sum(v) / len(v) for n, v in t[k].items()} for k in labels}
        base = labels[0]
        # the data kernel with dx asked (the code's gradient, on the CUDA
        # cores: 2 kin H FLOP a point), sn64's code and the wide ones, in turns
        with_dx = (base,) + tuple(k for k in labels if k.startswith("kin"))
        tdx = {k: [] for k in with_dx}
        for k in with_dx + with_dx[::-1]:
            tw, x, z, g, nb_c, _ = cases[k]
            tdx[k].append(cuda_ms(lambda: rv.bwd_data(g, z, x, tw, nb_c, True, **kw), 5))
        for k in with_dx:
            ms_dx = sum(tdx[k]) / len(tdx[k])
            log(f"deep backward time: resnetfc_bwd_data with dx at {k}, -V {NS}, {B} output "
                f"points: in turns {ms_dx:.4f} ms, {ms_dx / msd[k][names[0]]:.4f}x its time "
                f"without dx ({msd[k][names[0]]:.4f}); {ms_dx / (sum(tdx[base]) / len(tdx[base])):.4f}x "
                f"{base}'s with dx; on {smi}")
            records[names[0]].setdefault("dx", {})[k + ("" if NS == 1 else f", -V {NS}")] = dict(
                ms=ms_dx, without_dx_ms=msd[k][names[0]])
        for k in labels[1:]:  # the deepest last: the rest freed before its plain version
            tw, x, z, g, nb_c, dk = cases.pop(k)
            torch.cuda.empty_cache()
            plain, lib, bounds, flops = backward_yardsticks(tw, x, z, g, dk, NS, sb)
            plan = rv.weight_plan(tw.w_in.shape[0], 512, 512, nb_c, 3, NS, dk.pre, B,
                                  rv.kernel_limits(512), n_sms)
            for n in names:
                b_ms, b_by = bounds[n]
                ms_n = msd[k][n]
                log(f"deep backward time: {n} at {k} (sn64's widths), -V {NS}, {B} output "
                    f"points{f' ({rows} rows)' if NS > 1 else ''}: in turns {ms_n:.4f} ms beside "
                    f"{msd[base][n]:.4f} at {base} ({ms_n / msd[base][n]:.4f}x); "
                    f"{flops[n] / ms_n / 1e9:.1f} TFLOP/s; plain_ms {plain[n]:.4f}; library_ms "
                    f"{lib[n]:.4f}; bound_ms {b_ms:.4f} ({b_by}); {b_ms / ms_n:.3f} of the bound"
                    + (f"; {len(plan.maps)} tensor maps, {len(plan.table) // 6} products, "
                       f"{plan.tiles} output tiles" if n == names[1] else "") + f"; on {smi}")
                key = k.replace(" blocks", "").replace(", ", "_").replace(" ", "")
                records[n].setdefault("deep", {})[
                    ("b" if "kin" not in k else "") + key + ("" if NS == 1 else f"_ns{NS}")] = dict(
                    points=B, views=NS, ms=ms_n, base_ms_in_turns=msd[base][n], base=base,
                    plain_ms=plain[n], library_ms=lib[n], bound_ms=b_ms, bound_by=b_by,
                    tflops=flops[n] / ms_n / 1e9, share_of_bound=b_ms / ms_n)
            del tw, x, z, g, dk, plain, lib
        del cases

    # ---- the train CLI at d_hidden 384, 256, 64, 320, 192 and 200, at 8
    # blocks and on a 144-wide code, on the backward kernels; then at 8
    # blocks and on the 144-wide code beside the plain field in turns ----
    narrow_launches = {}
    restore = _env({"PIXELNERF_ALLOW_RANDOM_BACKBONE": "1"})  # no backbone weights here

    def train_cli(tag, keys, nviews, fmt, n_want, impl="auto"):
        with tempfile.TemporaryDirectory() as tmp:
            cpath = os.path.join(tmp, "narrow.conf")
            with open(cpath, "w") as fh:  # sn64's conf with other heads, as a file says it
                fh.write(f'include required("{os.path.abspath("conf/exp/sn64.conf")}")\n'
                         f"model {{ {keys} }}\n")
            rf.reset_launches()
            rv.reset_launches()
            t0 = time.perf_counter()
            trainer = train_main(
                ["-n", tag, "-c", cpath, "-F", fmt, "-D", nmr_root if fmt == "dvr" else dtu_root,
                 "-B", "4", "-V", str(nviews), "-R", "128", "--epochs", str(n_want),
                 "--checkpoints_path", os.path.join(tmp, "ck"), "--mlp_impl", impl])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        la = {k: v for k, v in dict(rf.LAUNCHES, **rv.LAUNCHES).items() if v}
        step_ms = 1e3 * sum(trainer.step_seconds[1:]) / max(1, trainer.global_step - 1)
        return trainer, la, wall, step_ms

    try:
        for what, keys, H, n_blocks, d_in_t, nviews, fmt, n_want in NARROW_TRAIN:
            fwd = STEP_KERNEL[nviews]
            trainer, la, wall, step_ms = train_cli(f"narrow{H}_{n_blocks}_{d_in_t}_v{nviews}", keys,
                                                   nviews, fmt, n_want)
            n_steps = trainer.global_step
            widths_ok = all((m.d_hidden, m.n_blocks, m.d_in) == (H, n_blocks, d_in_t)
                            for m in (trainer.net.mlp_coarse, trainer.net.mlp_fine))
            finite = n_steps == n_want and all(math.isfinite(v) for v in trainer.history)
            ok = (finite and widths_ok and not trainer.remat and set(la) == {fwd, *names}
                  and la["resnetfc_bwd_data"] == la["resnetfc_bwd_weights"] == 2 * n_steps
                  and la[fwd] >= 2 * n_steps and la[fwd] % 2 == 0)
            label = f"{what} -V {nviews} on -F {fmt}"
            log(f"narrow train path: python -m pixelnerf_tpu_torch.train -c conf/exp/sn64.conf + "
                f"model {{ {'; '.join(keys.splitlines())} }} -F {fmt} -B 4 -V {nviews} -R 128 (the "
                f"{rf.library_width(H)} library, kin {-(-d_in_t // 16) * 16}): {n_steps} steps "
                f"in {wall:.3f} s, {step_ms:.3f} ms a step after the first; remat "
                f"{trainer.remat}; launches {la} (want {fwd} and both backward kernels twice a "
                f"step, {fwd} twice more a validation batch); losses "
                f"{[round(v, 5) for v in trainer.history]}; on {smi}")
            if not ok:
                raise SystemExit(f"narrow: the {label} train steps failed or left the kernels")
            for name in (fwd, *names):
                narrow_launches.setdefault(name, {})[f"train CLI, {label}"] = la[name]
            del trainer
        for what, keys, n_want in TRAIN_TURNS:
            ms = {"auto": [], "torch": []}
            for impl in ("auto", "torch", "torch", "auto"):
                trainer, la, wall, step_ms = train_cli(f"turns_{impl}", keys, 1, "dvr", n_want, impl)
                kernels = {"resnetfc_bwd_data", "resnetfc_bwd_weights"} <= set(la)
                if (trainer.global_step != n_want or kernels != (impl == "auto")
                        or not all(math.isfinite(v) for v in trainer.history)):
                    raise SystemExit(f"narrow: the {what} train CLI with --mlp_impl {impl} failed "
                                     f"or took the wrong field ({la})")
                ms[impl].append(step_ms)
                del trainer
            mk, mp = (sum(v) / len(v) for v in (ms["auto"], ms["torch"]))
            log(f"narrow train turns: {what}, -V 1 on -F dvr, {n_want} steps a run (auto, torch, "
                f"torch, auto): {mk:.3f} ms a step after the first on the kernels {ms['auto']}, "
                f"{mp:.3f} on the plain field (--mlp_impl torch, the route these towers took "
                f"under grad before) {ms['torch']}: {mk / mp:.4f}x; on {smi}")
            records["resnetfc_bwd_data"].setdefault("train_turns", {})[what] = dict(
                kernel_ms=mk, plain_field_ms=mp, runs=ms)
    finally:
        restore()
    for name in names:
        records[name]["narrow_launches"] = narrow_launches[name]
    for name in (STEP_KERNEL[1], STEP_KERNEL[3]):
        records[name].setdefault("narrow_launches", {}).update(narrow_launches[name])

    # ---- each width's train step against the plain f32 step; the deep
    # towers' and the wide code's against the plain f32 step where the
    # plain step under AMP meets its guards, else within PARITY_MARGIN of
    # the AMP step's readings ----
    for H in NARROW_H + NEW_H:
        c = narrow_conf(conf, H)
        state = live_state(c, dev)
        step_parity(c, state, 1, dev, f"narrow d_hidden {H}")
        if H == NATIVE_H[0]:
            step_parity(c, state, 3, dev, f"narrow d_hidden {H}")
    c = narrow_conf(conf, 512, DEEP_DEPTHS[0])
    state = live_state(c, dev, keep=SHOW_KEEPS[1])
    for nviews in (1, 3):
        step_parity(c, state, nviews, dev, f"deep {DEEP_DEPTHS[0]} blocks", yardstick="plain_amp")
    c = narrow_conf(conf, 512, DEEP_DEPTHS[-1])
    state = live_state(c, dev, keep=SHOW_KEEPS[1])
    for nviews in (1, 3):
        for seed in PARITY_SEEDS:
            step_parity(c, state, nviews, dev, f"deep {DEEP_DEPTHS[-1]} blocks", seed=seed,
                        yardstick="plain_amp")
    c = narrow_conf(conf, 512)
    c.put("model.use_code_viewdirs", True)
    c.put("model.code.num_freqs", 11)
    # shaped to occupy half the points, this conf's coarse head kept sigma
    # <= 0 at every point of the parity batch (a zero gradient on every
    # route): 0.95 of them
    state = live_state(c, dev, keep=SHOW_KEEPS[-1])
    for nviews in (1, 3):
        step_parity(c, state, nviews, dev, "a 138-wide code (kin 144)", yardstick="plain_amp")

    # ---- widths, codes and depths outside the envelope stay plain under
    # grad (those the forward takes keep the forward kernels: past the gated
    # depth, and past the data kernel's program) ----
    for H, depth, d_in_o, C, cl_o, fwd_k in (
            (576, nb, d_in, 512, cl, True), (1024, nb, d_in, 512, cl, True),
            (512, nb, 520, 512, cl, False), (512, rv.GRAD_MAX_BLOCKS + 1, d_in, 512, cl, True),
            (512, 62, d_in, 512, cl, True), (64, 45, d_in, 4096, 4, True)):
        with torch.device("meta"):
            odd = ResnetFC(d_in=d_in_o, d_out=4, n_blocks=depth, d_latent=C, d_hidden=H,
                           combine_layer=cl_o, impl="auto")
        plain = odd._kernel_route((1, 64), dev, grad=True) is False
        forward = odd._kernel_route((1, 64), dev, grad=False)
        odd.impl = "cuda"
        try:
            odd._kernel_route((1, 64), dev, grad=True)
            refused = None
        except ValueError as e:
            refused = str(e)
        what = f"a d_hidden {H}, {depth}-block tower (d_in {d_in_o}, C = {C})"
        log(f"narrow: {what} under grad: plain under auto {plain}; impl='cuda' raises "
            f"{refused!r}; the forward kernels without grad {forward}")
        if not plain or refused is None or forward != fwd_k:
            raise SystemExit(f"narrow: {what} took the wrong route")
        del odd
    del towers
    log(f"narrow backward: phase done in {time.perf_counter() - t_phase:.1f} s")


# phase 19: the train CLI's visuals.  (label, conf, -F, -V, epochs, deferred
# code, the forward kernel the vis render must take)
VIS_RUNS = (("sn64", "conf/exp/sn64.conf", "dvr", 1, 2, False, "resnetfc_fwd_gather"),
            ("dtu", "conf/exp/dtu.conf", "dvr_dtu", 3, 1, False, "resnetfc_fwd_dense"),
            ("sn64, deferred code", "conf/exp/sn64.conf", "dvr", 1, 2, True,
             "resnetfc_fwd_gather_code"))


class VisRecorder:
    """While installed, wraps the train CLI's ``vis_render`` and
    ``PixelNeRFTrainer.vis_step``: each vis render is timed (synchronized),
    its forward-kernel launches counted, its kernel calls replayed against
    their plain versions right after it (``KernelCalls``, before the
    next train step moves the weights), its arguments and output kept; each
    vis step's grid and PSNR are kept."""

    def __init__(self, cli, rf):
        self.cli, self.rf, self.renders, self.steps = cli, rf, [], []

    def __enter__(self):
        from pixelnerf_tpu_torch.ops.replay import KernelCalls

        cli, rf = self.cli, self.rf
        self._render, self._step = cli.vis_render, cli.PixelNeRFTrainer.vis_step

        def render(*args, **kwargs):
            torch.cuda.synchronize()
            before = dict(rf.LAUNCHES)
            with KernelCalls() as calls:
                t0 = time.perf_counter()
                out = self._render(*args, **kwargs)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            after = dict(rf.LAUNCHES)
            launches = {k: v - before.get(k, 0) for k, v in after.items()
                        if v - before.get(k, 0)}
            replay = calls.check()
            rf.LAUNCHES.update(after)  # the replay's launches do not count
            self.renders.append(dict(args=args, kwargs=kwargs, out=out, s=dt, replay=replay,
                                     launches=launches))
            return out

        def step(trainer, data):
            res = self._step(trainer, data)
            self.steps.append(res)
            return res

        cli.vis_render, cli.PixelNeRFTrainer.vis_step = render, step
        return self

    def __exit__(self, *exc):
        self.cli.vis_render, self.cli.PixelNeRFTrainer.vis_step = self._render, self._step


def visuals_phase(dev, smi, records, code_records, nmr_root, dtu_root) -> None:
    """Phase 19: the train CLI's visuals (see the module docstring)."""
    import glob

    from pixelnerf_tpu_torch.data import get_split_dataset
    from pixelnerf_tpu_torch.models import make_model
    from pixelnerf_tpu_torch.ops import resnetfc_fused as rf
    from pixelnerf_tpu_torch.train import cli, main as train_main
    from pixelnerf_tpu_torch.train.diagnostic import DiagnosticTool
    from pixelnerf_tpu_torch.utils.png import read_png
    from pixelnerf_tpu_torch.utils.warping import warp_image

    t_phase = time.perf_counter()
    try:
        import tensorboardX  # noqa: F401
        have_tb = True
    except Exception:
        have_tb = False
    last_trainer = None
    for label, conf_path, fmt, nviews, epochs, defer, want in VIS_RUNS:
        env = {"PIXELNERF_ALLOW_RANDOM_BACKBONE": "1"}  # no backbone weights here
        if defer:
            env["PIXELNERF_DEFER_CODE"] = "1"
        restore = _env(env)
        try:
            with tempfile.TemporaryDirectory() as tmp, VisRecorder(cli, rf) as rec:
                cpath = os.path.join(tmp, "vis.conf")
                with open(cpath, "w") as fh:  # the shipped conf, a vis every epoch
                    fh.write(f'include required("{os.path.abspath(conf_path)}")\n'
                             "train { vis_interval = 1 }\n")
                name = "vis"
                root = nmr_root if fmt == "dvr" else dtu_root
                t0 = time.perf_counter()
                trainer = train_main(
                    ["-n", name, "-c", cpath, "-F", fmt, "-D", root, "-B", "4", "-V",
                     str(nviews), "-R", "128", "--epochs", str(epochs), "--fixed_test",
                     "--checkpoints_path", os.path.join(tmp, "ck"), "--visual_path",
                     os.path.join(tmp, "vis"), "--logs_path", os.path.join(tmp, "logs")])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                pngs = {e: os.path.join(tmp, "vis", name, f"{e:04d}_vis.png")
                        for e in range(epochs)}
                read = {e: read_png(p) if os.path.exists(p) else None for e, p in pngs.items()}
                events = glob.glob(os.path.join(tmp, "logs", name, "events.out.tfevents*"))
                # the last vis again on the plain f32 route: same weights and draws
                last = rec.renders[-1]
                plain = make_model(trainer.conf["model"], mlp_impl="torch", device=dev)
                plain.load_state_dict(trainer.net.state_dict())
                rf.reset_launches()
                out_plain = rec._render(plain, *last["args"][1:], **last["kwargs"])
                plain_launches = {k: v for k, v in rf.LAUNCHES.items() if v}
                del plain
        finally:
            restore()
        H, W = trainer.test_loader.dataset[0]["images"].shape[1:3]
        n_rays = H * W
        fine = lambda o: torch.from_numpy(o["fine"]["rgb"])  # noqa: E731
        p_plain = psnr(fine(last["out"]), fine(out_plain))
        replay = [row for r in rec.renders for row in r["replay"]]
        replay_txt = [(r["kernel"], r["points"], f"{r['max_abs_err']:.3g}", f"{r['bar']:.3g}",
                       f"{r['corr']:.6f}", r["identical"], r["ok"]) for r in replay]
        grids_ok = (len(rec.steps) == epochs == len(rec.renders)
                    and all(read[e] is not None and read[e].dtype.name == "uint8"
                            and read[e].shape == (2 * H, 5 * W, 3)
                            and read[e].tobytes() == rec.steps[e][0].tobytes()
                            for e in range(epochs)))
        launches_ok = all(set(r["launches"]) == {want} for r in rec.renders)
        for i, r in enumerate(rec.renders):
            log(f"visuals ({label}): vis render {i} (epoch {i}, -F {fmt}, one source view, a "
                f"{H} x {W} target from -R 128 x 16 = 2048-ray chunks): {r['s'] * 1e3:.3f} ms "
                f"= {n_rays / r['s']:.1f} rays/s (encode included); launches {r['launches']} "
                f"(want {want} only); psnr {rec.steps[i][1]:.4f} dB; on {smi}")
        log(f"visuals ({label}): python -m pixelnerf_tpu_torch.train -c {conf_path} + "
            f"vis_interval 1 -F {fmt} -B 4 -V {nviews} -R 128 --epochs {epochs} --fixed_test"
            f"{' with PIXELNERF_DEFER_CODE=1' if defer else ''}: {trainer.global_step} steps, "
            f"{wall:.3f} s; PNGs {[os.path.basename(p) for e, p in pngs.items() if read[e] is not None]} "
            f"{[None if g is None else g.shape for g in read.values()]} equal to the grids "
            f"{grids_ok}; TensorBoard {'event files ' + str(len(events)) if have_tb else 'tensorboardX does not import here: no writer'}; "
            f"last vis's fine rgb vs the plain f32 route (same weights and draws) "
            f"{p_plain:.3f} dB (need >= 40), plain-route launches {plain_launches}; replayed "
            f"kernel calls {replay_txt}")
        if not (grids_ok and launches_ok and p_plain >= 40.0 and not plain_launches
                and replay and all(row["ok"] for row in replay)
                and (events or not have_tb)):
            raise SystemExit(f"visuals ({label}): the vis failed, missed {want} or disagrees "
                             "with the plain route")
        rec_ = code_records[want] if want in code_records else records[want]
        rec_.setdefault("vis_launches", {})[label] = sum(r["launches"][want] for r in rec.renders)
        rec_.setdefault("vis_render_ms", {})[label] = [round(r["s"] * 1e3, 3) for r in rec.renders]
        if fmt == "dvr" and not defer:
            last_trainer = trainer
        del rec, out_plain

    # ---- DiagnosticTool on the sn64 net: the output check on the gather kernel ----
    ds = get_split_dataset("dvr", nmr_root, want_split="train")
    sample = ds[0]
    diag_net = make_model(last_trainer.conf["model"], mlp_impl="auto", device=dev)
    diag_net.load_state_dict(last_trainer.net.state_dict())
    with tempfile.TemporaryDirectory() as tmp:
        tool = DiagnosticTool(save_dir=tmp)
        data_ok = tool.check_data_range(ds, num_samples=2)
        arch_ok = tool.check_model_architecture(diag_net)
        rf.reset_launches()
        out_ok = tool.check_model_output(diag_net, sample)
        torch.cuda.synchronize()
    diag_launches = {k: v for k, v in rf.LAUNCHES.items() if v}
    log(f"visuals: DiagnosticTool on the sn64 net (the visuals run's trained weights, eval "
        f"routes): check_data_range {data_ok}, check_model_architecture {arch_ok}, "
        f"check_model_output {out_ok}; launches {diag_launches} (want resnetfc_fwd_gather)")
    if not (out_ok and arch_ok and data_ok and set(diag_launches) == {"resnetfc_fwd_gather"}):
        raise SystemExit("visuals: DiagnosticTool's checks failed or missed the gather kernel")
    records["resnetfc_fwd_gather"]["diagnostic_launches"] = diag_launches["resnetfc_fwd_gather"]
    del diag_net

    # ---- warp_image on one 300 x 400 DTU view ----
    dtu_val = get_split_dataset("dvr_dtu", dtu_root, want_split="val")
    dtu = dtu_val[0]
    img = torch.from_numpy(dtu["images"][:1] * 0.5 + 0.5).to(dev).contiguous()
    P = torch.from_numpy(dtu["poses"][:2]).to(dev, torch.float64)
    focal = torch.as_tensor(dtu["focal"], dtype=torch.float32).reshape(-1, 2)[0]
    c = torch.as_tensor(dtu["c"], dtype=torch.float32).reshape(-1, 2)[0]
    K = torch.tensor([[[focal[0], 0.0, c[0]], [0.0, focal[1], c[1]], [0.0, 0.0, 1.0]]],
                     device=dev)
    flip = torch.diag(torch.tensor([1.0, -1.0, -1.0, 1.0], dtype=torch.float64, device=dev))
    # OpenGL camera-to-world poses -> view 0's CV camera to view 1's
    rel = (flip @ torch.linalg.inv(P[1]) @ P[0] @ flip).float()[None]
    depth = torch.full((1,) + DTU_SIZE, 0.5 * (dtu_val.z_near + dtu_val.z_far), device=dev)
    warped, valid = warp_image(img, depth, K, rel)
    ms = cuda_ms(lambda: warp_image(img, depth, K, rel), 5)
    ok = bool(torch.isfinite(warped).all()) and warped.shape == img.shape and 0 < valid.mean() <= 1
    log(f"visuals: warp_image of DTU view 0 ({DTU_SIZE[0]} x {DTU_SIZE[1]}, a plane at mid "
        f"depth) into view 1: {ms:.3f} ms a call (mean of 5 after a warm-up), valid share "
        f"{valid.mean().item():.4f}, finite {ok}; on {smi}")
    if not ok:
        raise SystemExit("visuals: warp_image failed")
    log(f"visuals: phase done in {time.perf_counter() - t_phase:.1f} s")


# phase 20's kernels of each path, and its bars against one rank
MC_WANT = {"dryrun train": ("resnetfc_fwd_dense", "resnetfc_bwd_data", "resnetfc_bwd_weights"),
           "dryrun resume": ("resnetfc_fwd_dense", "resnetfc_bwd_data", "resnetfc_bwd_weights"),
           "dryrun eval": ("resnetfc_fwd_gather",),
           "train_0": ("resnetfc_fwd_dense", "resnetfc_bwd_data", "resnetfc_bwd_weights"),
           "train_1": ("resnetfc_fwd_dense", "resnetfc_bwd_data", "resnetfc_bwd_weights"),
           "eval": ("resnetfc_fwd_gather",),
           "gen_video": ("resnetfc_fwd_gather_code",)}
# the train CLI's step parity, two ranks against one: step 1 (no update yet:
# the sharding alone) at the dry run's step-1 bars, every later step's loss
# at the JAX dry run's step-2 bar; later steps' grad_norm is printed, since
# Adam's first updates, lr * sign(g), carry the ranks' bf16 rounding (at
# --lr 1e-4, the recipe's, and at 1e-6, where they move the weights 100x
# less)
MC_LRS, MC_STEP1_BARS, MC_LOSS_REL = (1e-4, 1e-6), (1e-4, 1e-3), 1e-3
# the share of a test view's points the gen_video field keeps occupied
MC_KEEP = 1 / 32
# the phase's conf, device and rank ids (two ranks sharing card 0)
MC_CONF, MC_DEVICE, MC_IDS = "conf/exp/sn64.conf", "cuda", (0, 0)


def shaped_checkpoint(trainer, nmr_root: str, ck: str) -> float:
    """The trainer's weights with each head's density shifted
    (``shape_density``) so that ``MC_KEEP`` of the points along the NMR test
    object's view 1 rays are occupied, saved as the ``mcv`` checkpoint
    under ``ck``: a field with empty space, so gen_video's grid is kept and
    its gate runs.  Returns ``MC_KEEP``."""
    import types

    import numpy as np

    from pixelnerf_tpu_torch.data import get_split_dataset
    from pixelnerf_tpu_torch.models import make_model
    from pixelnerf_tpu_torch.train import checkpoints
    from pixelnerf_tpu_torch.utils.geometry import gen_rays_np

    dev = next(trainer.net.parameters()).device
    shaped = make_model(trainer.conf["model"], mlp_impl="torch", device=dev)
    shaped.load_state_dict(trainer.net.state_dict())
    ds = get_split_dataset("dvr", nmr_root, want_split="test", training=False)
    d = ds[0]
    H, W = d["images"].shape[1:3]
    focal = np.asarray(d["focal"], np.float32)
    with torch.no_grad():
        scene = shaped.encode(torch.as_tensor(d["images"][None, :1], device=dev),
                              torch.as_tensor(d["poses"][None, :1], device=dev),
                              torch.as_tensor(focal, device=dev))
        rays = torch.from_numpy(gen_rays_np(d["poses"][1:2], W, H, focal, ds.z_near,
                                            ds.z_far).reshape(-1, 8)).to(dev)
        shape_density(shaped, scene, rays, MC_KEEP)
    checkpoints.save_weights(types.SimpleNamespace(checkpoints_path=ck, name="mcv"), shaped)
    return MC_KEEP


def multichip_phase(smi, records, code_records, nmr_root) -> None:
    """Phase 20: several ranks on the card (see the module docstring)."""
    import numpy as np

    from pixelnerf_tpu_torch import entry
    from pixelnerf_tpu_torch.eval import eval as eval_cli
    from pixelnerf_tpu_torch.eval import gen_video
    from pixelnerf_tpu_torch.ops import resnetfc_fused as rf
    from pixelnerf_tpu_torch.ops import resnetfc_vjp as rv
    from pixelnerf_tpu_torch.parallel import dryrun, launch
    from pixelnerf_tpu_torch.tools import check_config, memory_smoke, training_smoke
    from pixelnerf_tpu_torch.train import main as train_main
    from pixelnerf_tpu_torch.utils.png import read_png

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()  # the ranks' contexts share the card with this process
    by_path = {}  # kernel -> {path: launches summed over the ranks}

    def record(name: str):
        return records[name] if name in records else code_records.get(name)

    def take(path: str, res: dict) -> None:
        """Every rank launched each kernel of ``path``; every call a rank
        kept met the bar when replayed."""
        ranks = res["rank_launches"]
        missing = [k for k in MC_WANT[path] if not all(r.get(k, 0) for r in ranks)]
        bad = [row for rows in res["rank_replay"] for row in rows if not row["ok"]]
        n_rows = sum(len(rows) for rows in res["rank_replay"])
        for k in set().union(*ranks):
            by_path.setdefault(k, {})[path] = sum(r.get(k, 0) for r in ranks)
        worst = max((row["max_abs_err"] / row["bar"] for rows in res["rank_replay"]
                     for row in rows), default=0.0)
        log(f"multichip {path}: {len(ranks)} ranks, launches per rank {json.dumps(ranks)}; "
            f"{n_rows} kernel calls replayed in the ranks (worst max|d| / bar {worst:.4g}), "
            f"wall s per rank {[round(w, 3) for w in res['rank_wall_s']]}, peak MB per rank "
            f"{[round(m, 1) for m in res['rank_peak_mb']]}")
        if missing or bad or not n_rows:
            raise SystemExit(f"multichip {path}: kernels not launched in every rank {missing}, "
                             f"replays off the bar {bad}, {n_rows} replayed")
        for row in (row for rows in res["rank_replay"] for row in rows):
            rec = record(row["kernel"])
            if rec is not None:
                rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), row["max_abs_err"])

    # ---- the dry run: 4 ranks on card 0, data 2 x rays 2 ----
    t0 = time.perf_counter()
    mc = entry.dryrun_multichip(4, MC_DEVICE, replay=True)
    log(f"multichip dryrun: 4 ranks sharing card 0 over gloo, mesh data {mc['mesh'][0]} x rays "
        f"{mc['mesh'][1]}, sn64 full width on the kernel route; train rel delta loss "
        f"{mc['train'][0]:.3g} grad_norm {mc['train'][1]:.3g}, resume (step 2) rel delta against "
        f"one process from the same checkpoint loss {mc['resume_control'][0]:.3g} grad_norm "
        f"{mc['resume_control'][1]:.3g}, against two unsharded steps loss "
        f"{mc['resume'][0]:.3g} grad_norm {mc['resume'][1]:.3g} (weights after 2 steps: "
        f"{mc['drift'][0]} of {mc['drift'][1]} more than lr/2 from one process's), bit for bit "
        f"the unbroken sharded run {mc['exact']}, one process twice bit for bit {mc['repeat']}; "
        f"eval max|d| "
        f"rgb {mc['eval'][0]:.3g} depth {mc['eval'][1]:.3g}; {time.perf_counter() - t0:.1f} s "
        f"wall | {smi}")
    log("multichip dryrun: each step's gradient norm by module, sharded "
        + json.dumps(mc["sharded"]["train"]["module_grad_norms"]) + ", one process "
        + json.dumps(mc["single"]["single"]["module_grad_norms"]) + ", again "
        + json.dumps(mc["single"]["single_again"]["module_grad_norms"]))
    for path, leg in (("dryrun train", "train"), ("dryrun resume", "resume"),
                      ("dryrun eval", "eval")):
        take(path, mc["sharded"][leg])

    # ---- the CLIs on two ranks sharing card 0, each against one rank ----
    restore = _env({"PIXELNERF_ALLOW_RANDOM_BACKBONE": "1"})  # no backbone weights here
    try:
        with tempfile.TemporaryDirectory() as tmp:
            cpath = os.path.join(tmp, "mc.conf")
            with open(cpath, "w") as fh:  # sn64, a line every step, rank 0's vis after epoch 2
                fh.write(f'include required("{os.path.abspath(MC_CONF)}")\n'
                         "train { print_interval = 1\n vis_interval = 2 }\n")
            paths = ["-c", cpath, "-F", "dvr", "-D", nmr_root,
                     "--checkpoints_path", os.path.join(tmp, "ck"),
                     "--logs_path", os.path.join(tmp, "logs")]
            ids2 = " ".join(map(str, MC_IDS))

            def train_argv(name, ids, lr):
                return ["-n", name, "--gpu_id", ids, "-B", "4", "-V", "1", "-R", "128",
                        "--epochs", "3", "--lr", str(lr),
                        "--visual_path", os.path.join(tmp, "vis")] + paths

            def eval_argv(out, ids):
                return ["-n", "mc1", "--gpu_id", ids, "--split", "test", "-P", "0",
                        "--max_objs", "1", "-O", os.path.join(tmp, out)] + paths

            def video_argv(out, ids):
                return ["-n", "mcv", "--gpu_id", ids, "--split", "test", "-S", "0", "-P", "0",
                        "--num_views", "4", "--visual_path", os.path.join(tmp, out)] + paths

            one = {}
            for k, lr in enumerate(MC_LRS):
                t0 = time.perf_counter()
                one[k] = train_main(train_argv("mc1" if k == 0 else f"mc1_{k}", "0", lr))
                one[f"{k}_s"] = time.perf_counter() - t0
            n_floats = sum(p.numel() for p in one[0].net.parameters())
            vis_keep = shaped_checkpoint(one[0], nmr_root, os.path.join(tmp, "ck"))
            t0 = time.perf_counter()
            two = launch.spawn(dryrun.run_legs, MC_IDS, MC_DEVICE, dict(
                device=MC_DEVICE, replay=True, legs=[
                    dict(kind="collectives", name="collectives", floats=n_floats)] + [
                    dict(kind="cli", name=f"train_{k}", cli="train.cli",
                         argv=train_argv(f"mc2_{k}", ids2, lr))
                    for k, lr in enumerate(MC_LRS)] + [
                    dict(kind="cli", name="eval", cli="eval.eval", argv=eval_argv("ev2", ids2)),
                    dict(kind="cli", name="gen_video", cli="eval.gen_video",
                         argv=video_argv("gv2", ids2), env={"PIXELNERF_DEFER_CODE": "1"})]))
            two_s = time.perf_counter() - t0
            rf.reset_launches()
            ev1 = eval_cli.main(eval_argv("ev1", "0"))
            defer = _env({"PIXELNERF_DEFER_CODE": "1"})
            try:
                gv1 = gen_video.main(video_argv("gv1", "0"))
            finally:
                defer()
            one_render_launches = {k: v for k, v in rf.LAUNCHES.items() if v}
            pngs = sorted(os.path.relpath(p, os.path.join(tmp, "ev1")) for p in glob.glob(
                os.path.join(tmp, "ev1", "**", "*.png"), recursive=True))
            png_diff = max(int(np.abs(read_png(os.path.join(tmp, "ev1", p)).astype(np.int16)
                                      - read_png(os.path.join(tmp, "ev2", p))).max())
                           for p in pngs)
    finally:
        restore()
    coll = {k: v for k, v in two["collectives"].items() if not k.startswith("rank_")}
    log(f"multichip gloo: {json.dumps(coll)} (True: gloo takes a CUDA tensor as it is and gives "
        f"the right values; the launch module hands every collective its tensors as they are; "
        f"gradient_mean_ms: {n_floats} floats, sn64's parameters | {smi})")
    if not all(coll[k] is True for k in ("all_reduce", "broadcast", "all_gather")):
        raise SystemExit("multichip gloo: a collective refused a CUDA tensor or gave wrong values")

    def steps_of(tr1, t2):
        steps = list(zip(tr1.history, tr1.grad_norms, t2["losses"], t2["grad_norms"]))
        rel = [(abs(l2 - l1) / abs(l1), abs(g2 - g1) / abs(g1)) for l1, g1, l2, g2 in steps]
        return steps, rel

    for k, lr in enumerate(MC_LRS):
        tr1, t2 = one[k], two[f"train_{k}"]
        steps, rel = steps_of(tr1, t2)
        ms1 = 1e3 * float(np.median(tr1.step_seconds[1:]))
        ms2 = 1e3 * float(np.median(t2["step_s"][1:]))
        log(f"multichip train CLI, --lr {lr:g}: sn64 -F dvr -B 4 -V 1 -R 128, 3 steps, data 2 x "
            f"rays 1 on two ranks sharing card 0 against one rank: (loss, grad_norm) one rank "
            f"{[(round(a, 6), round(b, 5)) for a, b, _, _ in steps]}, two ranks "
            f"{[(round(c, 6), round(d, 5)) for _, _, c, d in steps]}, rel delta "
            f"{[(float(f'{a:.3g}'), float(f'{b:.3g}')) for a, b in rel]} (bars: step 1 "
            f"{MC_STEP1_BARS}, later losses {MC_LOSS_REL}, later grad_norm printed); ms a step "
            f"(median of steps 2-3) one rank {ms1:.2f}, two ranks {ms2:.2f} ({ms2 / ms1:.2f}x: "
            f"two contexts taking turns on one card and the gradient mean over gloo, not a "
            f"speed-up) | {smi}")
        if (len(steps) != 3 or rel[0][0] > MC_STEP1_BARS[0] or rel[0][1] > MC_STEP1_BARS[1]
                or any(a > MC_LOSS_REL for a, _ in rel)):
            raise SystemExit("multichip train CLI: two ranks part from one rank")
        take(f"train_{k}", t2)

    e1, e2 = ev1["objects"], two["eval"]["result"]["objects"]
    d_psnr = max(abs(a[1] - b[1]) for a, b in zip(e1, e2))
    d_ssim = max(abs(a[2] - b[2]) for a, b in zip(e1, e2))
    log(f"multichip eval CLI: -P 0 on the NMR test object, two ranks against one: objects "
        f"{[(n, round(p, 4), round(q, 5)) for n, p, q in e2]}, max |d PSNR| {d_psnr:.3g} dB, "
        f"|d SSIM| {d_ssim:.3g}, {len(pngs)} PNGs within {png_diff} u8 level(s)")
    if len(e1) != len(e2) or not e1 or d_psnr > 1e-3 or d_ssim > 1e-4 or png_diff > 1:
        raise SystemExit("multichip eval CLI: two ranks part from one rank")
    take("eval", two["eval"])

    f1, f2 = gv1["frames"], two["gen_video"]["result"]["frames"]
    f_diff = int(np.abs(f1.astype(np.int16) - f2).max())
    a1, a2 = gv1["accel"], two["gen_video"]["result"]["accel"]
    log(f"multichip gen_video: 4 frames of the field with {vis_keep:g} of a test view's points "
        f"occupied, the occupancy accel (one rank: {a1}; two ranks: {a2}), "
        f"PIXELNERF_DEFER_CODE=1, frames within {f_diff} u8 level(s); one rank's render "
        f"launches {one_render_launches}")
    if f1.shape != f2.shape or f_diff > 1 or a1 != a2 or a1 is None:
        raise SystemExit("multichip gen_video: two ranks part from one rank")
    take("gen_video", two["gen_video"])
    peak = {leg: [round(m, 1) for m in two[leg]["rank_peak_mb"]]
            for leg in ("train_0", "eval", "gen_video")}
    log(f"multichip CLIs: one launch of 2 ranks (the collectives, 2 train runs, eval, "
        f"gen_video) {two_s:.1f} s wall; one rank's first train run {one['0_s']:.1f} s; peak MB "
        f"per rank {json.dumps(peak)}")

    # ---- the root smoke tools' twins ----
    t0 = time.perf_counter()
    rcs = (training_smoke.main(["-c", MC_CONF, "--steps", "3", "--device", MC_DEVICE]),
           memory_smoke.main(["-F", "dvr", "-D", nmr_root, "--iters", "8"]),
           check_config.main([MC_CONF]))
    log(f"multichip tools: training_smoke, memory_smoke, check_config exit codes {rcs}, "
        f"{time.perf_counter() - t0:.1f} s")
    if any(rcs):
        raise SystemExit(f"a root smoke tool's twin failed: {rcs}")

    for name, paths in by_path.items():
        rec = record(name)
        if rec is not None:
            rec["multichip_launches"] = paths
    log(f"multichip: launches by path, summed over the ranks {json.dumps(by_path)}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")


# phase 21: ResNet50's latent (C = 832 / 1856 / 3904 at 3 / 4 / 5 layers) on
# the kernels, pieces of 512 columns in every row
R50_C = (832, 1856, 3904)
# the widths timed at the fine pass beside C = 512, in turns
R50_TIMED = (1856, 3904)
# the narrower libraries gated at a ResNet50 width (ragged B): d_hidden -> C
R50_NARROW = {384: 1856, 256: 1856, 128: 3904, 64: 3904}
# the train CLI's runs: (-V, -F); steps a run
R50_TRAIN = ((1, "dvr"), (3, "dvr_dtu"))
R50_TRAIN_STEPS = 3
# the repaired one-view renders: (backbone, encoder layers, C)
R50_REPAIRED = (("resnet50", 3, 832), ("resnet34", 5, 1024))


def r50_conf(base, num_layers: int = 4, backbone: str = "resnet50"):
    """sn64's conf (``base``) with the encoder's backbone and layers set, built
    in code as ``narrow_conf`` builds its confs: at 4 layers ResNet50's
    unified map is 1856 channels (64 + 256 + 512 + 1024) on sn64's 32 x 32
    grid; the heads keep sn64's widths (512 x 5, the latent in blocks 0-2,
    the views' mean at block 3)."""
    import copy

    c = copy.deepcopy(base)
    c.put("model.encoder.backbone", backbone)
    c.put("model.encoder.num_layers", num_layers)
    return c


def resnet50_phase(conf, net, src, src3, rays, dev, smi, records, code_records, nmr_root,
                   dtu_root) -> None:
    """Phase 21: ResNet50's latent on the kernels (see the module
    docstring); ``net`` is the render phases' sn64 model (ResNet34, C =
    512), timed beside the ResNet50 one in turns."""
    import types

    from pixelnerf_tpu_torch import entry
    from pixelnerf_tpu_torch.eval.eval import main as eval_main
    from pixelnerf_tpu_torch.models.code import PositionalEncoding
    from pixelnerf_tpu_torch.ops import resnetfc_fused as rf
    from pixelnerf_tpu_torch.ops import resnetfc_vjp as rv
    from pixelnerf_tpu_torch.ops.replay import KernelCalls
    from pixelnerf_tpu_torch.train import checkpoints
    from pixelnerf_tpu_torch.train import main as train_main

    t_phase = time.perf_counter()
    code = PositionalEncoding.from_conf(conf["model.code"], d_in=3)
    code_arrays = [torch.from_numpy(a).to(dev) for a in code.flat_arrays(tail=3)]
    d_in = code.d_out + 3
    gi = torch.Generator(device=dev).manual_seed(SEED + 21)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    T = 1024  # sn64's 32 x 32 map
    fine = RAYS_PER_STEP * 96
    ragged = (("gather", 1, 1, 2000), ("gather_mv", 2, 1, 1000), ("gather_mv", 3, 1, 333),
              ("dense", 1, 1, 2000), ("dense_mv", 3, 2, 333))

    def tables_of(C):  # seeded stand-ins of three views' (T, C) unified maps
        return (torch.randn(3, T, C, device=dev, generator=gi) * 0.5).to(torch.bfloat16)

    # ---- rows 1-4 and 6 at each ResNet50 width (d_hidden 512): gates at a
    # ragged B, then the fine pass timed beside C = 512 ----
    tw512 = bwd_tower(512, d_in, dev, SEED + 21)[1]
    tables512 = tables_of(512)
    for C in R50_C:
        tw = bwd_tower(C, d_in, dev, SEED + 21 + C)[1]
        tables = tables_of(C)
        for case in ragged:
            forward_check(tw, tables, code_arrays, gi, case, records, code_records, smi,
                          "resnet50 kernel check")
        if C in R50_TIMED:
            # the fine pass: 4096 rays x 96 samples (from 3 views at C = 3904
            # the dense kernel's rows are 393,216 in all: 131,072 a view)
            for kind, NS in (("gather", 1), ("dense", 1), ("gather_mv", 2), ("dense_mv", 3)):
                B = fine // 3 if (kind, C) == ("dense_mv", 3904) else fine
                forward_check(tw, tables, code_arrays, gi, (kind, NS, 1, B), records,
                              code_records, smi, "resnet50 kernel time",
                              ("C = 512", ("resnet50", f"c{C}"), "c512", tw512, tables512))
        del tw, tables
        torch.cuda.empty_cache()

    # ---- rows 5a / 5b at each width from 1 and 3 views (ragged, and the
    # train step's fine pass at 1856), then timed beside C = 512 ----
    names = ("resnetfc_bwd_data", "resnetfc_bwd_weights")
    towers = {C: bwd_tower(C, d_in, dev, SEED + 22 + C)[1] for C in (512,) + R50_C}
    for C in R50_C:
        shapes = NARROW_BWD_SHAPES if C == 1856 else NARROW_BWD_SHAPES[:2]
        for NS, sb, B_obj in shapes:
            x, z, g = bwd_inputs(code, gi, C, NS, sb, B_obj)
            backward_gate(towers[C], x, z, g, NS, sb, n_sms, records,
                          f"resnet50 backward check C = {C} (sn64's tower)")
            del x, z, g
    widths = (512,) + R50_TIMED
    for NS in (1, 3):
        sb, B_obj = 4, 128 * 96
        kw = dict(NS=NS, sb=sb, combine_layer=3) if NS > 1 else {}
        B, rows = sb * B_obj, NS * sb * B_obj
        case = {}
        for C in widths:
            x, z, g = bwd_inputs(code, gi, C, NS, sb, B_obj)
            case[C] = (x, z, g, rv.bwd_data(g, z, x, towers[C], 5, False, **kw))
        t = {C: {n: [] for n in names} for C in widths}
        for C in widths + widths[::-1]:  # in turns
            x, z, g, data = case[C]
            tw = towers[C]
            t[C][names[0]].append(cuda_ms(lambda: rv.bwd_data(g, z, x, tw, 5, False, **kw), 3))
            t[C][names[1]].append(cuda_ms(lambda: rv.bwd_weights(z, data, tw, 5), 3))
        ms = {C: {n: sum(v) / len(v) for n, v in t[C].items()} for C in widths}
        for C in R50_TIMED:
            x, z, g, data = case[C]
            plain, lib, bounds, flops = backward_yardsticks(towers[C], x, z, g, data, NS, sb)
            ws = sum(tt.numel() * tt.element_size()
                     for tt in (data.ws_act, data.ws_cot, data.ws_x, data.ws_z) if tt is not None)
            for n in names:
                b_ms, b_by = bounds[n]
                log(f"resnet50 backward time: {n} at C = {C} ({rv.dz_pieces(C, 512)} dz steps an "
                    f"injection), -V {NS}, {B} output points{f' ({rows} rows)' if NS > 1 else ''}"
                    f": in turns {ms[C][n]:.4f} ms beside {ms[512][n]:.4f} at C = 512 "
                    f"({ms[C][n] / ms[512][n]:.4f}x); {flops[n] / ms[C][n] / 1e9:.1f} TFLOP/s; "
                    f"plain_ms {plain[n]:.4f}; library_ms {lib[n]:.4f} ("
                    + ("autograd backward of the cuBLAS chain" if n == names[0]
                       else "cuBLAS bf16 A^T G a product")
                    + f"); bound_ms {b_ms:.4f} ({b_by}); {b_ms / ms[C][n]:.3f} of the bound; "
                    f"workspace {ws / 2**30:.3f} GiB, dz planes "
                    f"{rv.dz_pieces(C, 512) * rows * 512 * 4 / 2**30:.3f} GiB; on {smi}")
                records[n].setdefault("resnet50", {})[
                    f"c{C}" + ("" if NS == 1 else f"_ns{NS}")] = dict(
                    points=B, views=NS, ms=ms[C][n], c512_ms_in_turns=ms[512][n],
                    plain_ms=plain[n], library_ms=lib[n], bound_ms=b_ms, bound_by=b_by,
                    tflops=flops[n] / ms[C][n] / 1e9, share_of_bound=b_ms / ms[C][n])
        del case
    del towers
    torch.cuda.empty_cache()

    # ---- the narrower libraries at a ResNet50 width, ragged B ----
    for H, C in R50_NARROW.items():
        tw = bwd_tower(C, d_in, dev, SEED + 23 + H, H)[1]
        tables = tables_of(C)
        for case in ragged:
            forward_check(tw, tables, code_arrays, gi, case, records, code_records, smi,
                          "resnet50 narrow kernel check")
        for NS, sb, B_obj in NARROW_BWD_SHAPES[:2]:
            x, z, g = bwd_inputs(code, gi, C, NS, sb, B_obj)
            backward_gate(tw, x, z, g, NS, sb, n_sms, records,
                          f"resnet50 narrow backward check d_hidden {H}, C = {C} "
                          f"({rv.dz_pieces(C, H)} dz steps an injection)")
            del x, z, g
        del tw, tables

    # ---- the ResNet50 model: ring frame 0 on every route from 1, 2 and 3
    # views, and the repaired one-view renders ----
    code_env = {"PIXELNERF_DEFER_CODE": "1"}
    dense = {"PIXELNERF_FUSED_GATHER_MAX_ROWS": "0"}
    frame_rays = rays[:RAYS_PER_STEP]

    def frame0(model, c, s, views, env):
        restore = _env(env)
        try:
            rf.reset_launches()
            rv.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, _ = entry.render_ring(model, c, s, frame_rays,
                                       torch.Generator(device=dev).manual_seed(SEED),
                                       RAYS_PER_STEP, views=views)
            torch.cuda.synchronize()
            return (out, time.perf_counter() - t0,
                    {k: v for k, v in dict(rf.LAUNCHES, **rv.LAUNCHES).items() if v})
        finally:
            restore()

    def models_of(c):
        m = {impl: entry.build_model(c, dev, mlp_impl=impl, seed=SEED) for impl in ("auto", "torch")}
        g = torch.Generator().manual_seed(SEED + 1)
        with torch.no_grad():  # every block live, as the render phases' model
            for mlp in (m["auto"].mlp_coarse, m["auto"].mlp_fine):
                for blk in mlp.blocks:
                    blk.fc_1.weight.copy_(0.02 * torch.randn(blk.fc_1.weight.shape, generator=g))
        m["torch"].load_state_dict(m["auto"].state_dict())
        return m

    c50 = r50_conf(conf)
    m50 = models_of(c50)
    log(f"resnet50: conf/exp/sn64.conf with model.encoder.backbone = resnet50 (4 layers, no first "
        f"pool): a {tuple(m50['auto'].encoder.latent_sizes)} unified map of C = "
        f"{m50['auto'].d_latent} channels, {sum(p.numel() for p in m50['auto'].encoder.parameters())} "
        f"encoder parameters; ResnetFC 512 x 5 heads; seeded, random encoder, fc_1 ~ N(0, 0.02^2)")
    if m50["auto"].d_latent != 1856:
        raise SystemExit(f"resnet50: the unified map is {m50['auto'].d_latent} wide, not 1856")
    routes = [(src, (0,), {}, "resnetfc_fwd_gather"), (src, (0,), dense, "resnetfc_fwd_dense"),
              (src3, (0, 1), {}, "resnetfc_fwd_gather_mv"),
              (src3, (0, 1, 2), {}, "resnetfc_fwd_dense_mv")]
    routes += [(s, v, dict(e, **code_env), k + "_code") for s, v, e, k in routes]

    def label_of(views, env):
        return (f"views {list(views)}" + (", dense route" if dense.keys() & env.keys() else "")
                + (", deferred code" if code_env.keys() & env.keys() else ""))

    r50_launches = {}
    calls = KernelCalls()
    with calls:
        for s, views, env, kname in routes:
            ref, _, la_ref = frame0(m50["torch"], c50, s, views, env)
            out, sec, la = frame0(m50["auto"], c50, s, views, env)
            p = psnr(out, ref)
            label = label_of(views, env)
            ok = set(la) == {kname} and not la_ref and bool(torch.isfinite(out).all()) and p >= 40
            r50_launches.setdefault(kname, {})[f"ResNet50 frame 0, {label}"] = la.get(kname, 0)
            log(f"resnet50 render: {label}: frame 0 {sec:.4f} s (encode included); launches {la} "
                f"(want {kname}); vs the plain f32 route {p:.3f} dB (need >= 40); on {smi}")
            if not ok:
                raise SystemExit(f"resnet50 render {label} missed {kname} or disagrees with the "
                                 "plain route")
        for backbone, layers, C in R50_REPAIRED:
            c = r50_conf(conf, layers, backbone)
            m = models_of(c)
            if m["auto"].d_latent != C:
                raise SystemExit(f"resnet50: {backbone} at {layers} layers is {m['auto'].d_latent} "
                                 f"wide, not {C}")
            # each head's density shaped on the view's scene, so that the
            # frame shows the object (a random trunk's latent left it blank)
            keep = show_object(m, src, (0,), frame_rays,
                               lambda mt: frame0(mt, c, src, (0,), {})[0])
            ref, _, _ = frame0(m["torch"], c, src, (0,), {})
            out, sec, la = frame0(m["auto"], c, src, (0,), {})
            p, fg = psnr(out, ref), foreground(out)
            ok = (set(la) == {"resnetfc_fwd_gather"} and p >= 40 and fg > 0
                  and bool(torch.isfinite(out).all()))
            r50_launches.setdefault("resnetfc_fwd_gather", {})[
                f"{backbone} {layers} layers (C = {C}) frame 0, views [0]"] = la.get(
                "resnetfc_fwd_gather", 0)
            log(f"resnet50 repaired render: {backbone} at {layers} layers (C = {C}), views [0]: "
                f"frame 0 on the fused gather, no ValueError: launches {la} (want "
                f"resnetfc_fwd_gather); vs the plain f32 route {p:.3f} dB (need >= 40); "
                f"foreground {fg:.4f} (need > 0; the density shaped to occupy {keep:.3g} of frame "
                f"0's points); the frame's rgb std {out.std().item():.4g}; on {smi}")
            if not ok:
                raise SystemExit(f"resnet50: the {backbone} {layers}-layer one-view render left "
                                 "the fused gather or disagrees with the plain route")
            del m
    replayed(calls.check(), "resnet50", records, code_records)
    del calls

    # ---- frame 0 beside sn64's ResNet34 model, in turns (sn64, R50, R50, sn64) ----
    for s, views, env, kname in routes[:4]:
        t = {"sn64": [], "resnet50": []}
        for which in ("sn64", "resnet50", "resnet50", "sn64"):
            model, c = (net, conf) if which == "sn64" else (m50["auto"], c50)
            t[which].append(frame0(model, c, s, views, env)[1])
        s34, s50 = (sum(t[k]) / 2 for k in ("sn64", "resnet50"))
        log(f"resnet50 render: {label_of(views, env)}: frame 0 (encode included) {s50:.4f} s = "
            f"{RAYS_PER_STEP / s50:.1f} rays/s beside sn64's (ResNet34, C = 512) {s34:.4f} s = "
            f"{RAYS_PER_STEP / s34:.1f} rays/s in turns ({s50 / s34:.3f}x); on {smi}")
        records[kname].setdefault("resnet50", {})["frame0_rays_per_s"] = RAYS_PER_STEP / s50

    # ---- the eval CLI and the train CLI on the ResNet50 conf ----
    restore = _env({"PIXELNERF_ALLOW_RANDOM_BACKBONE": "1"})  # no backbone weights here
    try:
        with tempfile.TemporaryDirectory() as tmp:
            ck = os.path.join(tmp, "ck")
            checkpoints.save_weights(types.SimpleNamespace(checkpoints_path=ck, name="r50"),
                                     m50["auto"])
            cpath = os.path.join(tmp, "r50.conf")
            with open(cpath, "w") as fh:  # sn64's conf with ResNet50, as a file says it
                fh.write(f'include required("{os.path.abspath("conf/exp/sn64.conf")}")\n'
                         "model { encoder { backbone = resnet50 } }\n")
            out_dir = os.path.join(tmp, "eval0")
            torch.cuda.synchronize()
            rf.reset_launches()
            t0 = time.perf_counter()
            res = eval_main(["-n", "r50", "-c", cpath, "-F", "dvr", "-D", nmr_root, "--split",
                             "test", "-P", "0", "--max_objs", "1", "-O", out_dir,
                             "--checkpoints_path", ck, "-R", str(EVAL_RAYS)])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            la = {k: v for k, v in rf.LAUNCHES.items() if v}
            n_rays = (NMR_VIEWS - 1) * FRAME * FRAME
            ok = (res["cnt"] == 1 and len(res["objects"]) == 1
                  and all(math.isfinite(v) for _, p_, s_ in res["objects"] for v in (p_, s_))
                  and set(la) == {"resnetfc_fwd_gather"})
            log(f"resnet50 eval: python -m pixelnerf_tpu_torch.eval.eval -c conf/exp/sn64.conf + "
                f"backbone resnet50 -F dvr --split test -P \"0\": "
                f"{[(n, round(p_, 4), round(s_, 4)) for n, p_, s_ in res['objects']]}; launches "
                f"{la} (want resnetfc_fwd_gather); {dt:.3f} s wall, {n_rays} rays = "
                f"{n_rays / dt:.1f} rays/s (model build and load included); on {smi}")
            if not ok:
                raise SystemExit("resnet50 eval -P '0' failed or did not run through "
                                 "resnetfc_fwd_gather")
            r50_launches.setdefault("resnetfc_fwd_gather", {})["ResNet50 eval -P \"0\""] = la[
                "resnetfc_fwd_gather"]
            for nviews, fmt in R50_TRAIN:
                fwd = STEP_KERNEL[nviews]
                rf.reset_launches()
                rv.reset_launches()
                t0 = time.perf_counter()
                trainer = train_main(
                    ["-n", f"r50_v{nviews}", "-c", cpath, "-F", fmt, "-D",
                     nmr_root if fmt == "dvr" else dtu_root, "-B", "4", "-V", str(nviews), "-R",
                     "128", "--epochs", str(R50_TRAIN_STEPS), "--checkpoints_path",
                     os.path.join(tmp, f"ck_train{nviews}")])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                la = {k: v for k, v in dict(rf.LAUNCHES, **rv.LAUNCHES).items() if v}
                n_steps = trainer.global_step
                finite = (n_steps == R50_TRAIN_STEPS
                          and all(math.isfinite(v) for v in trainer.history))
                step_ms = 1e3 * sum(trainer.step_seconds[1:]) / max(1, n_steps - 1)
                ok = (finite and trainer.net.d_latent == 1856 and not trainer.remat
                      and set(la) == {fwd, *names}
                      and la["resnetfc_bwd_data"] == la["resnetfc_bwd_weights"] == 2 * n_steps
                      and la[fwd] >= 2 * n_steps and la[fwd] % 2 == 0)
                log(f"resnet50 train path: python -m pixelnerf_tpu_torch.train -c "
                    f"conf/exp/sn64.conf + backbone resnet50 -F {fmt} -B 4 -V {nviews} -R 128: "
                    f"{n_steps} steps in {wall:.3f} s, {step_ms:.3f} ms a step after the first; "
                    f"remat {trainer.remat}; launches {la} (want {fwd} and both backward kernels "
                    f"twice a step); losses {[round(v, 5) for v in trainer.history]}; on {smi}")
                if not ok:
                    raise SystemExit(f"resnet50: the -V {nviews} train steps failed or left the "
                                     "kernels")
                for n in (fwd, *names):
                    r50_launches.setdefault(n, {})[f"ResNet50 train CLI, -V {nviews} on -F {fmt}"] \
                        = la[n]
                del trainer
    finally:
        restore()
    for name, by_path in r50_launches.items():
        (records[name] if name in records else code_records[name])["resnet50_launches"] = by_path
    del m50

    # ---- the train step from 1 and 3 views against the plain f32 step ----
    state = live_state(c50, dev)
    for nviews in (1, 3):
        step_parity(c50, state, nviews, dev, "resnet50 (C = 1856)")
    log(f"resnet50: phase done in {time.perf_counter() - t_phase:.1f} s")


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card", file=sys.stderr)
        sys.exit(2)
    from pixelnerf_tpu_torch import entry
    from pixelnerf_tpu_torch.device import resolve_device
    from pixelnerf_tpu_torch.models.code import PositionalEncoding
    from pixelnerf_tpu_torch.ops import resnetfc_fused as rf
    from pixelnerf_tpu_torch.ops.grid_sample import bilinear_taps
    from pixelnerf_tpu_torch.ops.replay import agree

    t_start = time.perf_counter()
    dev = resolve_device("cuda")
    card = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| {torch.cuda.device_count()} visible")

    # ---- build: the backward, and the forward at each hidden width ----
    t0 = time.perf_counter()
    builds = rf.build_all()  # one nvcc a library, all at once
    from pixelnerf_tpu_torch.ops import resnetfc_vjp as rv

    bwd_sass_at = {H: sass_counts(builds["bwd", H].library) for H in rf.BWD_HIDDEN}
    fwd_sass_at = {H: sass_counts(builds["fwd", H].library) for H in rf.FWD_HIDDEN}
    label = {k: f"{k[0]} (d_hidden {k[1]})" for k in builds}
    log("build: " + json.dumps({
        "kernels": list(rf.LAUNCHES) + ["resnetfc_bwd_data", "resnetfc_bwd_weights"],
        "sources": sorted({str(rf.SOURCES[n].relative_to(rf.CSRC.parent.parent))
                           for n, _ in builds}),
        "libraries": {label[k]: b.library.name for k, b in builds.items()},
        "compiled": {label[k]: b.compiled for k, b in builds.items()},
        "seconds": round(time.perf_counter() - t0, 3),
        "ptxas": {label[k]: ptxas_summary(b.log) for k, b in builds.items()},
        "sass": {**{f"bwd (d_hidden {H})": c for H, c in bwd_sass_at.items()},
                 **{f"fwd (d_hidden {H})": c for H, c in fwd_sass_at.items()}},
        "resnetfc_bwd_weights_kernel smem bytes": {
            H: rv._lib(H).resnetfc_bwd_weights_smem_bytes() for H in rf.BWD_HIDDEN},
    }))
    # in each width's backward library, the weights kernel and the data kernel
    # (both instantiations) are wgmma kernels fed by TMA, with no wmma product
    bwd_ptxas_at = {H: ptxas_summary(builds["bwd", H].log) for H in rf.BWD_HIDDEN}
    checked = []
    for H, bs in bwd_sass_at.items():
        for name in ("resnetfc_bwd_weights_kernel", "resnetfc_bwd_data_kernel<MV=0>",
                     "resnetfc_bwd_data_kernel<MV=1>"):
            d_sass = bs.get(name, {})
            if not (d_sass.get("HGMMA") and d_sass.get("UTMALDG") and d_sass.get("HMMA") == 0):
                raise SystemExit(f"{name} at d_hidden {H} is not a wgmma + TMA kernel: {d_sass}")
            checked.append((f"{name} at d_hidden {H}", bwd_ptxas_at[H].get(name, "")))
    # so are both instantiations of every forward kernel (the 64-point tile)
    # in each width's library, and no kernel of a forward library holds a
    # wmma product; no kernel of any library spills
    fwd_ptxas_at = {H: ptxas_summary(builds["fwd", H].log) for H in rf.FWD_HIDDEN}
    dense_names = tuple(f"resnetfc_fwd_{k}_kernel<CODE={c}>"
                        for k in ("dense", "gather", "dense_mv", "gather_mv") for c in (0, 1))
    for H, fs in fwd_sass_at.items():
        for name in dense_names:
            d_sass = fs.get(name, {})
            if not (d_sass.get("HGMMA") and d_sass.get("UTMALDG") and d_sass.get("HMMA") == 0):
                raise SystemExit(f"{name} at d_hidden {H} is not a wgmma + TMA kernel: {d_sass}")
        if not fs or any(c.get("HMMA") for c in fs.values()):
            raise SystemExit(f"a kernel of the d_hidden {H} forward library holds a wmma "
                             f"product: {fs}")
        checked += [(f"{n} at d_hidden {H}", fwd_ptxas_at[H].get(n, "")) for n in dense_names]
    for name, line in checked:
        spills = re.findall(r"(\d+) B spill", line)
        if len(spills) != 2 or any(int(v) for v in spills):
            raise SystemExit(f"{name} spills or ptxas gave no spill line: {line}")
    for H in rf.FWD_HIDDEN:
        lim = rf.dense_limits(H)
        log(f"build: forward kernels' registers at d_hidden {H} (the dense forward, the fused "
            f"gather, the multi-view dense forward and the multi-view gather, all on the "
            f"64-point tile; library {builds['fwd', H].library.name}): "
            + json.dumps(fwd_ptxas_at[H]) + f"; SASS {json.dumps(fwd_sass_at[H])}; shared "
            f"memory {lim.smem} B a CTA (dynamic; at most {rf.MAX_SMEM_BYTES}), cluster "
            f"{lim.cluster} CTA{'s' if lim.cluster > 1 else ''} a tile, {lim.stages} ring "
            f"stages, on {smi}")
    for H in rf.BWD_HIDDEN:
        log(f"build: backward kernels' registers at d_hidden {H} (library "
            f"{builds['bwd', H].library.name}): " + json.dumps(bwd_ptxas_at[H])
            + f"; SASS {json.dumps(bwd_sass_at[H])}; resnetfc_bwd_data shared memory "
            f"{rv.data_limits(H).smem} B a CTA, {rv.data_limits(H)}")

    # ---- the main path's model: full sn64 width, seeded, every block live ----
    conf = entry.load_conf(pretrained=False)
    net = entry.build_model(conf, dev, mlp_impl="auto", seed=SEED)
    g = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        for mlp in (net.mlp_coarse, net.mlp_fine):
            for blk in mlp.blocks:  # fc_1 starts at zero, which would leave fc_0 unused
                blk.fc_1.weight.copy_(0.02 * torch.randn(blk.fc_1.weight.shape, generator=g))
    mlp = net.mlp_fine
    tw = mlp.tower(dev)
    nb, H, C = mlp.n_blocks, mlp.d_hidden, mlp.d_latent
    n_lin_z, d_in, d_out = mlp.n_lin_z, mlp.d_in, mlp.d_out
    src = entry.source_view(FRAME, SEED)
    src3 = entry.source_view(FRAME, SEED, views=(0, 1, 2))  # the same object, three views
    with torch.no_grad():
        scene = net.encode(torch.as_tensor(src["images"], device=dev),
                           torch.as_tensor(src["poses"], device=dev), float(src["focal"]))
        scene3 = net.encode(torch.as_tensor(src3["images"], device=dev),
                            torch.as_tensor(src3["poses"], device=dev), float(src3["focal"]))
    table = scene.latents.reshape(-1, C).to(torch.bfloat16).contiguous()
    T = table.shape[0]
    tables3 = scene3.latents.reshape(3, T, C).to(torch.bfloat16).contiguous()
    cl = mlp.combine_layer

    # ---- the one-view kernels (rows 1 and 2, and row 6's twins) on the 64-point tile ----
    # a ragged B (2000 = 31 x 64 + 16), the -V 1 train step's fine pass and
    # one ray chunk x 64 and x 96 samples (the render's coarse and fine
    # passes), encoded and deferred code, on the encoded source view's table
    # with taps outside it in 1 of 16 rows: the dense kernel on the gathered
    # bf16 latent and the gather kernel on the taps, each against its plain
    # version at the bar and bit-identical on a second call, the gather kernel
    # also bit-identical to the dense one
    gi = torch.Generator(device=dev).manual_seed(SEED + 2)
    code = PositionalEncoding.from_conf(conf["model.code"], d_in=3)
    code_arrays = [torch.from_numpy(a).to(dev) for a in code.flat_arrays(tail=3)]
    records = {"resnetfc_fwd_gather": {}, "resnetfc_fwd_dense": {}}
    # the weights a 64-point tile streams from L2; the gather kernel also
    # reads 4 table rows a point an injection
    tile_w = sum(t.numel() * t.element_size() for t in (tw.w_in, tw.w_z, tw.w_blk))
    tile_rows = n_lin_z * 64 * 4 * C * table.element_size()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    tile_ms = {}  # (variant, B) -> ms
    flops_pt = 2 * H * (d_in + n_lin_z * C + 2 * nb * H + d_out)
    w_bytes = sum(t.numel() * t.element_size() for t in tw[:8])
    side = int(math.isqrt(T))
    for B in (2000, 128 * 4 * 96, RAYS_PER_STEP * 64, RAYS_PER_STEP * 96):
        pts = torch.rand(B, 3, device=dev, generator=gi) * 2 - 1
        vd = torch.nn.functional.normalize(torch.randn(B, 3, device=dev, generator=gi), dim=-1)
        x = torch.cat([code(pts), vd], dim=-1).contiguous()
        idx, w = bilinear_taps(torch.rand(B, 2, device=dev, generator=gi) * 2 - 1, side, side,
                               pad_taps_to=8)
        idx[0::32, 0] = -1  # taps outside the table contribute nothing
        idx[16::32, 3] = T
        idx, w = idx.contiguous(), w.contiguous()
        timed = B >= RAYS_PER_STEP * 64 or B == 128 * 4 * 96
        with torch.no_grad():
            z = rf.gather_reference(idx, w, table, torch.bfloat16).to(torch.bfloat16)
            rc = rf.RawCode(torch.cat([pts, vd], dim=-1).contiguous(), *code_arrays)
            dense_out = {}
            for variant, xi in (("resnetfc_fwd_dense", x), ("resnetfc_fwd_dense_code", rc),
                                ("resnetfc_fwd_gather", x), ("resnetfc_fwd_gather_code", rc)):
                gather = variant.startswith("resnetfc_fwd_gather")
                if gather:
                    kern = lambda: rf.resnetfc_gather(idx, w, table, xi, tw, nb)  # noqa: E731
                else:
                    kern = lambda: rf.resnetfc_dense(z, xi, tw, nb)  # noqa: E731
                out = kern()
                torch.cuda.synchronize()
                ref = rf.resnetfc_reference(z, xi, tw, nb, compute_dtype=torch.bfloat16)
                d, bar, corr = agree(out, ref)
                identical = torch.equal(out, kern())
                ok = d <= bar and corr > 0.999 and bool(torch.isfinite(out).all()) and identical
                line = (f"kernel check: {variant} (64-point tile) B={B} max|d| {d:.6g} <= bar "
                        f"{bar:.6g}: {d <= bar}, corr {corr:.7f}, bit-identical on a second call "
                        f"{identical}")
                twin = variant.replace("gather", "dense")
                if gather:  # the same tile, program and operand bits as the dense kernel's
                    same = torch.equal(out, dense_out[twin])
                    ok = ok and same
                    line += f", bit-identical to {twin} on gather_reference's bf16 latent {same}"
                else:
                    dense_out[variant] = out
                ms = cuda_ms(kern, 5)
                tile_ms[(variant, B)] = ms
                line += f"; kernel_ms {ms:.4f}"
                if timed:
                    plain = ((lambda: rf.resnetfc_reference(  # noqa: E731
                        rf.gather_reference(idx, w, table, torch.bfloat16), xi, tw, nb,
                        compute_dtype=torch.bfloat16)) if gather
                        else (lambda: rf.resnetfc_reference(  # noqa: E731
                            z, xi, tw, nb, compute_dtype=torch.bfloat16)))
                    plain_ms = cuda_ms(plain, 2)
                    xl = x if xi is x else None
                    # (rows outside the table clamped: the yardstick's time, not its value)
                    zl = ((lambda: (table[idx[:, :4].long().clamp(0, T - 1)]
                                    * w[:, :4, None].bfloat16()).sum(1))
                          if gather else (lambda: z))
                    library_ms = cuda_ms(lambda: library_tower(
                        zl(), xl if xl is not None else rf.materialize_code(rc), tw, nb), 5)
                    raw_d = rc.x.shape[1]
                    x_bytes = B * (d_in * 4 if xl is not None else raw_d * 4)
                    lat_bytes = (B * (idx.shape[1] + w.shape[1]) * 4 + T * C * 2 if gather
                                 else B * C * 2)
                    extra = (0 if xl is not None else B * 2 * raw_d * d_in) + (
                        B * 8 * C if gather else 0)
                    b_ms, b_by = bound(B * flops_pt + extra,
                                       x_bytes + lat_bytes + B * d_out * 4 + w_bytes)
                    tiles = rf.dense_grid(B, rf.dense_limits())
                    per_tile = tile_w + (tile_rows if gather else 0)
                    l2 = tiles * per_tile / ms / 1e9
                    line += (f", {B * flops_pt / ms / 1e9:.1f} TFLOP/s, {b_ms / ms:.3f} of the "
                             f"bound ({b_ms:.4f} ms, {b_by}); plain_ms {plain_ms:.4f} library_ms "
                             f"{library_ms:.4f}; streamed from L2 {per_tile / 2**20:.2f} MiB a "
                             f"64-point tile (weights {tile_w / 2**20:.2f}"
                             + (f" + table rows {tile_rows / 2**20:.2f}" if gather else "")
                             + f"), {l2:.3f} TB/s = {l2 * 1e3 / n_sm:.2f} GB/s an SM")
                    if variant in records:
                        rec = records[variant]
                        if B == RAYS_PER_STEP * 96:  # times at the fine pass's shape
                            rec.update(name=variant, route="cuda",
                                       source="pixelnerf_tpu_torch/csrc/resnetfc_fwd.cu",
                                       replaces=("pixelnerf_tpu/ops/resnetfc_pallas.py:248" if gather
                                                 else "pixelnerf_tpu/ops/resnetfc_pallas.py:175"),
                                       ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                       library_ms=library_ms, tflops=B * flops_pt / ms / 1e9,
                                       share_of_bound=b_ms / ms, stream_tb_s=l2,
                                       design="64-point tiles on wgmma m64n128k16 (tile64.cuh), "
                                              "weights by TMA through a 3-stage mbarrier ring, "
                                              "each warpgroup feeding its own half"
                                              + ("; the 4-tap lookup built by the threads into "
                                                 "the latent's operand tile" if gather else ""))
                        elif B == 128 * 4 * 96 or B == RAYS_PER_STEP * 64:
                            rec[f"points_{B}"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                                      library_ms=library_ms, stream_tb_s=l2)
                log(line)
                if not ok:
                    raise SystemExit(f"kernel check failed: {variant} at B={B}")
                if variant in records:
                    rec = records[variant]
                    rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), d)
            del out, ref, z, x, rc, idx, w, pts, vd, dense_out

    # ---- multi-view forward kernel checks at the multi-view paths' shapes ----
    # both multi-view kernels on the 64-point tile, encoded and CODE at every
    # case, each against its plain version at the bar, bit-identical on a
    # second call with one launch: the multi-view gather (row 4) at the NS =
    # 2 render's passes on the encoded tables of views 0 and 1 and at a
    # ragged NS 3 x 333, bit for bit the multi-view dense kernel on
    # mv_latent's latent; the multi-view dense kernel (row 3) at the NS = 3
    # render's dense route, the -V 3 train step's layout (SB 4 objects x NS 3
    # views x 128 rays x 96 samples), and, gates only, NS = 2, a ragged SB 2
    # x NS 3 x 333 (tiles that straddle two objects) and NS 12 and 24 (one
    # view's program walked 12 and 24 times)
    def flops_mv(NS):
        return 2 * H * (NS * (d_in + cl * (C + 2 * H)) + 2 * (nb - cl) * H + d_out)

    records.update({"resnetfc_fwd_gather_mv": {}, "resnetfc_fwd_dense_mv": {}})
    mv_ms = {}  # (kernel, samples) -> ms, for the kernels' share of a frame
    mv_cases = [("resnetfc_fwd_gather_mv", 2, 1, RAYS_PER_STEP, K) for K in (64, 96)]
    mv_cases += [("resnetfc_fwd_gather_mv", 3, 1, 333, None)]
    mv_cases += [("resnetfc_fwd_dense_mv", 3, 1, RAYS_PER_STEP, K) for K in (64, 96)]
    mv_cases += [("resnetfc_fwd_dense_mv", 3, 4, 128, 96), ("resnetfc_fwd_dense_mv", 2, 1,
                                                            RAYS_PER_STEP, 64),
                 ("resnetfc_fwd_dense_mv", 3, 2, 333, None), ("resnetfc_fwd_dense_mv", 12, 1, 8192, None),
                 ("resnetfc_fwd_dense_mv", 24, 2, 333, None)]
    kin = tw.w_in.shape[0]
    mb = H * H * 2  # one (512, 512) bf16 block matrix
    for name, NS, sb, n_rays, K in mv_cases:
        B = sb * n_rays * (K or 1)  # output points
        rows = NS * B
        gather = name == "resnetfc_fwd_gather_mv"
        timed = K is not None and (gather or NS == 3)
        pts = torch.rand(rows, 3, device=dev, generator=gi) * 2 - 1
        vd = torch.nn.functional.normalize(torch.randn(rows, 3, device=dev, generator=gi), dim=-1)
        x = torch.cat([code(pts), vd], dim=-1).contiguous()
        rc = rf.RawCode(torch.cat([pts, vd], dim=-1).contiguous(), *code_arrays)
        side = int(math.isqrt(T))
        idx, w = bilinear_taps(torch.rand(rows, 2, device=dev, generator=gi) * 2 - 1, side, side,
                               pad_taps_to=8)
        if gather:  # taps outside each view's table contribute nothing
            idx[0::32, 0] = -1
            idx[16::32, 3] = T
        idx, w = idx.contiguous(), w.contiguous()
        tabs = tables3[torch.arange(NS, device=dev) % 3].contiguous()  # views past 3 repeat them
        shape = (f"NS={NS} SB={sb} x " + (f"{n_rays} rays x {K} = " if K else "B_obj ")
                 + f"{B} points ({rows} rows)")
        with torch.no_grad():
            z = mv_latent(tabs, idx, w, sb)
            xv = by_view(x, NS, sb)
            # each kernel, encoded and CODE: against its plain version at the
            # bar and bit-identical on a second call; the gather also bit for
            # bit the dense kernel on the same latent
            for variant, xi in ((name, x), (name + "_code", rc)):
                if gather:
                    kern = lambda: rf.resnetfc_gather_mv(idx, w, tabs, xi, tw, nb, cl)  # noqa: E731
                else:
                    kern = lambda: rf.resnetfc_dense_mv(z, xi, tw, nb, NS, cl, sb)  # noqa: E731
                plain = lambda: rf.resnetfc_reference(  # noqa: E731
                    z, xi, tw, nb, compute_dtype=torch.bfloat16, NS=NS, sb=sb, combine_layer=cl)
                before = dict(rf.LAUNCHES)
                out = kern()
                torch.cuda.synchronize()
                launched = {k: v - before[k] for k, v in rf.LAUNCHES.items() if v != before[k]}
                ref = plain()
                d, bar, corr = agree(out, ref)
                identical = torch.equal(out, kern())
                ok = (d <= bar and corr > 0.999 and bool(torch.isfinite(out).all())
                      and out.shape == (d_out, B) and identical and launched == {variant: 1})
                line = (f"kernel check: {variant} (64-point tile) {shape} max|d| {d:.6g} <= bar "
                        f"{bar:.6g}: {d <= bar}, corr {corr:.7f}, bit-identical on a second call "
                        f"{identical}, launches {launched}")
                if gather:
                    twin = variant.replace("gather", "dense")
                    same = torch.equal(out, rf.resnetfc_dense_mv(z, xi, tw, nb, NS, cl, sb))
                    ok = ok and same
                    line += f", bit-identical to {twin} on mv_latent's bf16 latent {same}"
                if timed and variant == name:
                    ms = cuda_ms(kern, 5)
                    plain_ms = cuda_ms(plain, 2)
                    if gather:
                        views = torch.arange(NS, device=dev)[:, None, None]
                        # (rows outside the tables clamped: the yardstick's time, not its value)
                        library = lambda: library_tower_mv(  # noqa: E731
                            (tabs[views, idx[:, :4].reshape(NS, B, 4).long().clamp(0, T - 1)]
                             * w[:, :4].reshape(NS, B, 4, 1).bfloat16()).sum(2), xv, tw, nb, NS,
                            cl)
                        in_bytes = (rows * (idx.shape[1] * 4 + w.shape[1] * 4 + d_in * 4)
                                    + NS * T * C * 2)
                        b_ms, b_by = bound(B * (flops_mv(NS) + NS * 8 * C),
                                           in_bytes + B * d_out * 4 + w_bytes)
                    else:
                        zv = by_view(z, NS, sb)
                        library = lambda: library_tower_mv(zv, xv, tw, nb, NS, cl)  # noqa: E731
                        b_ms, b_by = bound(B * flops_mv(NS),
                                           rows * (C * 2 + d_in * 4) + B * d_out * 4 + w_bytes)
                    library_ms = cuda_ms(library, 3)
                    grid = rf.dense_mv_grid(B, n_sm, rf.dense_limits())
                    tiles = rf.dense_grid(B, rf.dense_limits())
                    # what a 64-point tile streams into its SM: the weights (the
                    # layers below the mean once a view), each view's latent
                    # rows (the gather: 4 table rows a point an injection) and
                    # the view-sum slot (written, read and written at middle
                    # views, read)
                    tw_mv = (NS * (kin * H * 2 + n_lin_z * C * H * 2 + 2 * cl * mb)
                             + 2 * (nb - cl) * mb)
                    t_lat = NS * n_lin_z * 64 * C * 2 * (4 if gather else 1)
                    t_slot = 2 * (NS - 1) * rf.dense_limits().slot_floats * 4
                    per_tile = tw_mv + t_lat + t_slot
                    l2 = tiles * per_tile / ms / 1e9
                    line += (f"; kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
                             f"{library_ms:.4f} bound_ms {b_ms:.4f} ({b_by}); "
                             f"{B * flops_mv(NS) / ms / 1e9:.1f} TFLOP/s, {b_ms / ms:.3f} of the "
                             f"bound; grid {grid} persistent CTAs over {tiles} tiles "
                             f"({tiles / grid:.2f} rounds); streamed into each SM "
                             f"{per_tile / 2**20:.2f} MiB a 64-point tile (weights "
                             f"{tw_mv / 2**20:.2f} + {'table rows' if gather else 'latent'} "
                             f"{t_lat / 2**20:.3f} + slot {t_slot / 2**20:.3f}), {l2:.3f} TB/s "
                             f"= {l2 * 1e3 / n_sm:.2f} GB/s an SM")
                    rec = records[name]
                    if sb == 1:
                        mv_ms[(name, K)] = ms
                    t = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=library_ms, tflops=B * flops_mv(NS) / ms / 1e9,
                             share_of_bound=b_ms / ms, stream_tb_s=l2, grid=grid, tiles=tiles)
                    if sb == 1 and K == 96:  # times at the render's fine pass
                        rec.update(name=name, route="cuda",
                                   source="pixelnerf_tpu_torch/csrc/resnetfc_fwd.cu",
                                   replaces=("pixelnerf_tpu/ops/resnetfc_pallas.py:463" if gather
                                             else "pixelnerf_tpu/ops/resnetfc_pallas.py:399"),
                                   design="64-point tiles on wgmma m64n128k16 (tile64.cuh), weights "
                                          "by TMA through a 3-stage mbarrier ring fed per "
                                          "warpgroup, persistent CTAs with a 128 KB view-sum "
                                          "slot each, one view's steps walked NS times"
                                          + ("; each view's 4-tap lookup built by the threads "
                                             "into the latent's operand tile" if gather else ""),
                                   **t)
                    else:
                        rec[f"points_{B}_sb{sb}"] = t
                log(line)
                if not ok:
                    raise SystemExit(f"kernel check failed: {variant} {shape}")
                if variant == name:
                    rec = records[name]
                    rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), d)
                del out, ref
            del z, x, rc, idx, w, xv, pts, vd, tabs

    # ---- row 6: the deferred positional code in each forward kernel ----
    # every CODE variant at the fine pass (4096 rays x 96 = 393,216 output
    # points) on the raw (xyz, viewdir) coordinates, against its plain
    # version (the code in f32, then the bf16 tower) and against the same
    # kernel fed the pre-encoded code, where only bf16 rounding flips of the
    # code may differ
    d_raw = code_arrays[0].shape[0]
    code_records = {}
    B = RAYS_PER_STEP * 96
    for name, NS in (("resnetfc_fwd_gather_code", 1), ("resnetfc_fwd_dense_code", 1),
                     ("resnetfc_fwd_gather_mv_code", 2), ("resnetfc_fwd_dense_mv_code", 3)):
        rows = NS * B
        pts = torch.rand(rows, 3, device=dev, generator=gi) * 2 - 1
        vd = torch.nn.functional.normalize(torch.randn(rows, 3, device=dev, generator=gi), dim=-1)
        rc = rf.RawCode(torch.cat([pts, vd], dim=-1).contiguous(), *code_arrays)
        side = int(math.isqrt(T))
        idx, w = bilinear_taps(torch.rand(rows, 2, device=dev, generator=gi) * 2 - 1, side, side,
                               pad_taps_to=8)
        idx, w = idx.contiguous(), w.contiguous()
        with torch.no_grad():
            x_enc = rf.materialize_code(rc)  # the plain version's f32 code
            tabs = table if NS == 1 else tables3[:NS].contiguous()
            # the bf16 latents the dense kernels read (the gather kernels build
            # the same from the table)
            zl = (rf.gather_reference(idx, w, table, torch.bfloat16) if NS == 1
                  else mv_latent(tabs, idx, w, 1)).to(torch.bfloat16)
            if name == "resnetfc_fwd_gather_code":
                kern = lambda x: rf.resnetfc_gather(idx, w, table, x, tw, nb)  # noqa: E731
            elif name == "resnetfc_fwd_dense_code":
                kern = lambda x: rf.resnetfc_dense(zl, x, tw, nb)  # noqa: E731
            elif name == "resnetfc_fwd_gather_mv_code":
                kern = lambda x: rf.resnetfc_gather_mv(idx, w, tabs, x, tw, nb, cl)  # noqa: E731
            else:
                kern = lambda x: rf.resnetfc_dense_mv(zl, x, tw, nb, NS, cl)  # noqa: E731
            kw = dict(NS=NS, combine_layer=cl) if NS > 1 else {}
            plain = lambda: rf.resnetfc_reference(zl, rc, tw, nb,  # noqa: E731
                                                  compute_dtype=torch.bfloat16, **kw)
            # the yardstick: the code in torch, then rows 1-4's cuBLAS chains
            # (with the lookup for the gather variants)
            if name == "resnetfc_fwd_gather_code":
                library = lambda: library_tower(  # noqa: E731
                    (table[idx[:, :4].long()] * w[:, :4, None].bfloat16()).sum(1),
                    rf.materialize_code(rc), tw, nb)
            elif name == "resnetfc_fwd_dense_code":
                library = lambda: library_tower(zl, rf.materialize_code(rc), tw, nb)  # noqa: E731
            elif name == "resnetfc_fwd_gather_mv_code":
                views = torch.arange(NS, device=dev)[:, None, None]
                library = lambda: library_tower_mv(  # noqa: E731
                    (tabs[views, idx[:, :4].reshape(NS, B, 4).long()]
                     * w[:, :4].reshape(NS, B, 4, 1).bfloat16()).sum(2),
                    by_view(rf.materialize_code(rc), NS, 1), tw, nb, NS, cl)
            else:
                zv = by_view(zl, NS, 1)
                library = lambda: library_tower_mv(  # noqa: E731
                    zv, by_view(rf.materialize_code(rc), NS, 1), tw, nb, NS, cl)
            before = dict(rf.LAUNCHES)
            out = kern(rc)
            torch.cuda.synchronize()
            launched = {k: v - before[k] for k, v in rf.LAUNCHES.items() if v != before[k]}
            ref = plain()
            d, bar, corr = agree(out, ref)
            out_enc = kern(x_enc)
            d_enc = (out - out_enc).abs().max().item()
            ok = (d <= bar and corr > 0.999 and bool(torch.isfinite(out).all())
                  and out.shape == (d_out, B) and launched == {name: 1})
            ms = cuda_ms(lambda: kern(rc), 5)
            enc_ms = cuda_ms(lambda: kern(x_enc), 5)
            plain_ms = cuda_ms(plain, 2)
            library_ms = cuda_ms(library, 3)
            f_pt = flops_pt if NS == 1 else flops_mv(NS)
            gather = "gather" in name
            in_bytes = (rows * (d_raw * 4 + ((idx.shape[1] + w.shape[1]) * 4 if gather else C * 2))
                        + (NS * T * C * 2 if gather else 0))
            b_ms, b_by = bound(B * f_pt + rows * (2 * d_raw * d_in + (8 * C if gather else 0)),
                               in_bytes + B * d_out * 4 + w_bytes)
            log(f"kernel check: {name} (row 6, _x_feat in the "
                f"{name.removesuffix('_code')} kernel) NS={NS} B={B} ({rows} rows, raw d {d_raw} "
                f"-> code d {d_in}) max|d| {d:.6g} <= bar {bar:.6g}: {d <= bar}, corr {corr:.7f}; "
                f"vs the same kernel on the pre-encoded code max|d| {d_enc:.6g}; launches "
                f"{launched}; kernel_ms {ms:.4f} (encoded input {enc_ms:.4f}, ratio "
                f"{ms / enc_ms:.4f}) plain_ms {plain_ms:.4f} library_ms {library_ms:.4f} "
                f"bound_ms {b_ms:.4f} ({b_by})")
            if not ok:
                raise SystemExit(f"kernel check failed: {name}")
            code_records[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                      library_ms=library_ms, max_abs_err=d, encoded_ms=enc_ms,
                                      encoded_max_abs_err=d_enc, points=B, rows=rows)
            del out, ref, out_enc, x_enc, zl, rc, idx, w, pts, vd

    # ---- main path: full-width sn64 ring render on the kernel route ----
    rays = entry.ring_rays(src, N_FRAMES)
    log("main path: sn64 full width (ResNet34 4 layers, ResnetFC 512 x 5 blocks), "
        "seeded weights, encoder.pretrained=false (random backbone), fc_1 ~ N(0, 0.02^2); "
        f"{N_FRAMES} frames of {FRAME}x{FRAME}, {RAYS_PER_STEP} rays per step")
    torch.cuda.synchronize()
    rf.reset_launches()
    t0 = time.perf_counter()
    rgb, depth = entry.render_ring(net, conf, src, rays,
                                   torch.Generator(device=dev).manual_seed(SEED), RAYS_PER_STEP)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    main_launches = dict(rf.LAUNCHES)
    frames = rgb.reshape(N_FRAMES, FRAME, FRAME, 3)
    ok = (bool(torch.isfinite(rgb).all()) and bool(torch.isfinite(depth).all())
          and frames.shape == (N_FRAMES, FRAME, FRAME, 3))
    log(f"main path: launches {main_launches}; {rays.shape[0]} rays in {dt:.4f} s = "
        f"{rays.shape[0] / dt:.1f} rays/s (encode + render, first call) on {smi}; "
        f"finite {ok}; rgb range [{rgb.min().item():.4f}, {rgb.max().item():.4f}]")
    if not ok or main_launches["resnetfc_fwd_gather"] == 0:
        raise SystemExit("main path failed or did not launch the gather kernel")
    records["resnetfc_fwd_gather"]["launches"] = main_launches["resnetfc_fwd_gather"]
    t0 = time.perf_counter()
    entry.render_ring(net, conf, src, rays, torch.Generator(device=dev).manual_seed(SEED),
                      RAYS_PER_STEP)
    torch.cuda.synchronize()
    steady = time.perf_counter() - t0
    frame_kernel_ms = (tile_ms[("resnetfc_fwd_gather", RAYS_PER_STEP * 64)]  # coarse + fine
                       + tile_ms[("resnetfc_fwd_gather", RAYS_PER_STEP * 96)])
    log(f"main path, second call: {rays.shape[0]} rays in {steady:.4f} s = "
        f"{rays.shape[0] / steady:.1f} rays/s; gather kernel {frame_kernel_ms:.3f} ms per "
        f"frame = {frame_kernel_ms * N_FRAMES / 1e3 / steady:.3f} of the render time")

    plain_net = entry.build_model(conf, dev, mlp_impl="torch", seed=SEED)
    plain_net.load_state_dict(net.state_dict())
    rf.reset_launches()
    rgb_p, _ = entry.render_ring(plain_net, conf, src, rays[:RAYS_PER_STEP],
                                 torch.Generator(device=dev).manual_seed(SEED), RAYS_PER_STEP)
    torch.cuda.synchronize()
    p_plain = psnr(rgb[:RAYS_PER_STEP], rgb_p)
    log(f"main path: frame 0 kernel route vs plain route (f32 torch, same generator seed) "
        f"PSNR {p_plain:.3f} dB (need >= 40); plain-route launches {dict(rf.LAUNCHES)}")
    if not p_plain >= 40.0 or any(rf.LAUNCHES.values()):
        raise SystemExit("kernel route disagrees with the plain route")
    plain_frame0 = {(0,): rgb_p}  # the plain route's frame 0 per source views

    # ---- dense route: no fused gather ----
    # frame 0 through the dense kernel, then frame 0 on both routes timed in
    # turns (gather, dense, dense, gather), encode included
    def frame0_route(dense):
        if dense:
            os.environ["PIXELNERF_FUSED_GATHER_MAX_ROWS"] = "0"
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, _ = entry.render_ring(net, conf, src, rays[:RAYS_PER_STEP],
                                       torch.Generator(device=dev).manual_seed(SEED),
                                       RAYS_PER_STEP)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0
        finally:
            os.environ.pop("PIXELNERF_FUSED_GATHER_MAX_ROWS", None)

    rf.reset_launches()
    rgb_d, _ = frame0_route(True)
    dense_launches = dict(rf.LAUNCHES)
    route_s = {False: [], True: []}
    for dense in (False, True, True, False):
        route_s[dense].append(frame0_route(dense)[1])
    gather_frame_s, dense_frame_s = (sum(route_s[k]) / 2 for k in (False, True))
    p_dense = psnr(rgb[:RAYS_PER_STEP], rgb_d)
    p_dense_plain = psnr(rgb_d, plain_frame0[(0,)])
    dense_frame_ms = (tile_ms[("resnetfc_fwd_dense", RAYS_PER_STEP * 64)]
                      + tile_ms[("resnetfc_fwd_dense", RAYS_PER_STEP * 96)])
    log(f"dense route: PIXELNERF_FUSED_GATHER_MAX_ROWS=0, frame 0: launches {dense_launches}; "
        f"vs plain route PSNR {p_dense_plain:.3f} dB (need >= 40), vs gather route "
        f"{p_dense:.3f} dB; finite {bool(torch.isfinite(rgb_d).all())}")
    log(f"render routes, frame 0 (encode + render), means of two calls each in turns (gather, "
        f"dense, dense, gather): gather route {gather_frame_s:.4f} s = "
        f"{RAYS_PER_STEP / gather_frame_s:.1f} rays/s, gather kernel {frame_kernel_ms:.3f} ms = "
        f"{frame_kernel_ms / 1e3 / gather_frame_s:.3f} of it; dense route {dense_frame_s:.4f} s = "
        f"{RAYS_PER_STEP / dense_frame_s:.1f} rays/s, dense kernel {dense_frame_ms:.3f} ms = "
        f"{dense_frame_ms / 1e3 / dense_frame_s:.3f} of it; runs {json.dumps(route_s)}")
    if (dense_launches["resnetfc_fwd_dense"] == 0 or not bool(torch.isfinite(rgb_d).all())
            or not p_dense_plain >= 40.0):
        raise SystemExit("dense route did not launch the dense kernel or disagrees with the plain "
                         "route")
    records["resnetfc_fwd_dense"]["launches"] = dense_launches["resnetfc_fwd_dense"]

    # ---- multi-view render: 2 and 3 source views of the same object ----
    for views, kname in (((0, 1), "resnetfc_fwd_gather_mv"), ((0, 1, 2), "resnetfc_fwd_dense_mv")):
        NS = len(views)
        fused = net._fused_gather_ok(scene3.latents[:NS], NS)
        torch.cuda.synchronize()
        rf.reset_launches()
        t0 = time.perf_counter()
        rgb_m, depth_m = entry.render_ring(net, conf, src3, rays,
                                           torch.Generator(device=dev).manual_seed(SEED),
                                           RAYS_PER_STEP, views=views)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        mv_launches = dict(rf.LAUNCHES)
        t0 = time.perf_counter()
        entry.render_ring(net, conf, src3, rays, torch.Generator(device=dev).manual_seed(SEED),
                          RAYS_PER_STEP, views=views)
        torch.cuda.synchronize()
        steady = time.perf_counter() - t0
        frame0_s = []  # frame 0 alone (encode + render), twice
        for _ in range(2):
            t0 = time.perf_counter()
            entry.render_ring(net, conf, src3, rays[:RAYS_PER_STEP],
                              torch.Generator(device=dev).manual_seed(SEED), RAYS_PER_STEP,
                              views=views)
            torch.cuda.synchronize()
            frame0_s.append(time.perf_counter() - t0)
        f0 = sum(frame0_s) / 2
        rf.reset_launches()
        rgb_p, _ = entry.render_ring(plain_net, conf, src3, rays[:RAYS_PER_STEP],
                                     torch.Generator(device=dev).manual_seed(SEED), RAYS_PER_STEP,
                                     views=views)
        torch.cuda.synchronize()
        plain_launches = dict(rf.LAUNCHES)
        plain_frame0[views] = rgb_p
        p_mv = psnr(rgb_m[:RAYS_PER_STEP], rgb_p)
        frame_ms = mv_ms[(kname, 64)] + mv_ms[(kname, 96)]
        finite = bool(torch.isfinite(rgb_m).all()) and bool(torch.isfinite(depth_m).all())
        log(f"multi-view render: source views {list(views)} (NS={NS}, NS x T = {NS * T} rows, "
            f"fused gather {fused}): launches {mv_launches}; {rays.shape[0]} rays in {dt:.4f} s "
            f"(encode + render, first call), second call {steady:.4f} s = "
            f"{rays.shape[0] / steady:.1f} rays/s; {kname} {frame_ms:.3f} ms per frame = "
            f"{frame_ms * N_FRAMES / 1e3 / steady:.3f} of the render time; frame 0 alone "
            f"{f0:.4f} s (mean of {[round(t_, 4) for t_ in frame0_s]}) = "
            f"{RAYS_PER_STEP / f0:.1f} rays/s, {kname} {frame_ms / 1e3 / f0:.3f} of it; frame 0 vs "
            f"plain route "
            f"PSNR {p_mv:.3f} dB (need >= 40); plain-route launches {plain_launches}; "
            f"finite {finite}")
        others = [k for k in mv_launches if k != kname]
        if not (finite and p_mv >= 40.0 and mv_launches[kname] > 0
                and not any(mv_launches[k] for k in others) and not any(plain_launches.values())
                and fused == (kname == "resnetfc_fwd_gather_mv")):
            raise SystemExit(f"multi-view render from views {views} failed or missed {kname}")
        records[kname]["launches"] = mv_launches[kname]

    # ---- deferred-code renders: PIXELNERF_DEFER_CODE=1 on every forward route ----
    # frame 0 from views (0), (0, 1), (0, 1, 2) and on the dense route; the
    # code variant of the route's kernel must launch and the encoded-input one
    # not, and the frame agree with the plain route (without the deferred
    # code) to >= 40 dB.  Then frame 0 is timed with the code off and on, in
    # turns (off, on, on, off).
    def frame0(views, defer):
        os.environ["PIXELNERF_DEFER_CODE"] = "1" if defer else "0"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _ = entry.render_ring(net, conf, src3, rays[:RAYS_PER_STEP],
                                   torch.Generator(device=dev).manual_seed(SEED), RAYS_PER_STEP,
                                   views=views)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for views, cap, kname in (((0,), None, "resnetfc_fwd_gather"),
                              ((0,), "0", "resnetfc_fwd_dense"),
                              ((0, 1), None, "resnetfc_fwd_gather_mv"),
                              ((0, 1, 2), None, "resnetfc_fwd_dense_mv")):
        if cap is not None:
            os.environ["PIXELNERF_FUSED_GATHER_MAX_ROWS"] = cap
        try:
            rf.reset_launches()
            rgb_c, _ = frame0(views, True)
            defer_launches = dict(rf.LAUNCHES)
            times = {False: [], True: []}
            for defer in (False, True, True, False):
                times[defer].append(frame0(views, defer)[1])
        finally:
            os.environ.pop("PIXELNERF_DEFER_CODE", None)
            os.environ.pop("PIXELNERF_FUSED_GATHER_MAX_ROWS", None)
        cname = kname + "_code"
        p_c = psnr(rgb_c, plain_frame0[views])
        finite = bool(torch.isfinite(rgb_c).all())
        t_off, t_on = (sum(times[k]) / 2 for k in (False, True))
        log(f"deferred-code render: PIXELNERF_DEFER_CODE=1, source views {list(views)}"
            f"{', PIXELNERF_FUSED_GATHER_MAX_ROWS=' + cap if cap else ''}, frame 0: launches "
            f"{defer_launches}; vs plain route PSNR {p_c:.3f} dB (need >= 40); finite {finite}; "
            f"frame 0 in {t_on:.4f} s with the deferred code, {t_off:.4f} s without (means of two "
            f"calls each, in turns)")
        if not (finite and p_c >= 40.0 and defer_launches[cname] > 0
                and not any(v for k, v in defer_launches.items() if k != cname)):
            raise SystemExit(f"deferred-code render from views {views} failed or missed {cname}")
        code_records[cname]["launches"] = defer_launches[cname]

    # ---- backward kernel checks at the train step's shapes, -V 1 and -V 3 ----
    records.update({"resnetfc_bwd_data": {}, "resnetfc_bwd_weights": {}})
    # the backward's two kernels and the step's dense forward, per (views, pass shape)
    bwd_ms, fwd_ms, weights_ms_at = {}, {}, {}
    # the train step's shapes (-B 4 objects x -R 128 rays x samples), and a
    # ragged B at each view count: B_pad an odd multiple of 32, so the data
    # kernel's last 64-point tile is half full (gates only, no timing); and,
    # gates only, -V 10 (ragged) and -V 25 at small B_obj: the data kernel's
    # program walked 10 and 25 times, and at -V 25 the weights kernel's
    # splits of two views each (B_pad 320).
    # Past -V 3 the kernels are held to their own plain versions (the
    # backward walked through the kernel's operands, the weights' products
    # on its DataOut), not to the independent plain backward, whose own bf16
    # recompute flips enough relu masks at 25 views of 320 points to move a
    # gradient's corr below 0.999 (0.9987 at 25 x 352 points on an H100)
    for NS, K, sb, B_obj in ((1, 64, 4, 128 * 64), (1, 96, 4, 128 * 96), (1, None, 2, 1000),
                             (3, 64, 4, 128 * 64), (3, 96, 4, 128 * 96), (3, None, 2, 333),
                             (10, None, 2, 333), (25, None, 1, 320)):
        ragged = K is None
        B = sb * B_obj
        rows = NS * B
        kw = dict(NS=NS, sb=sb, combine_layer=cl) if NS > 1 else {}
        pts = torch.rand(rows, 3, device=dev, generator=gi) * 2 - 1
        vd = torch.nn.functional.normalize(torch.randn(rows, 3, device=dev, generator=gi), dim=-1)
        x = torch.cat([code(pts), vd], dim=-1).contiguous()
        idx, w = bilinear_taps(torch.rand(rows, 2, device=dev, generator=gi) * 2 - 1, 32, 32,
                               pad_taps_to=8)
        z = mv_latent(tables3[torch.arange(NS, device=dev) % 3] if NS > 1 else table[None], idx,
                      w, sb)
        g = torch.randn(d_out, B, device=dev, generator=gi)
        data = rv.bwd_data(g, z, x, tw, nb, True, **kw)
        gr = rv.bwd_weights(z, data, tw, nb)
        torch.cuda.synchronize()
        ops_k = data.ws_act[:, :B].float()
        ops_p = rv.forward_operands(z, x, tw, nb, torch.bfloat16, **kw)
        d, bar, corr = agree(ops_k, ops_p)
        flips = ((ops_k > 0) != (ops_p > 0)).float().mean().item()
        ok = d <= bar and corr > 0.999 and flips <= 1e-3
        shape = (f"-V {NS}: {sb} x {B_obj} = {B} points (gates only"
                 + (", the last 64-point tile half full)" if (B + 31) // 32 % 2 else ")") if ragged
                 else f"-V {NS}: {sb} x 128 rays x {K} = {B} points")
        shape += f", {rows} rows" if NS > 1 else ""
        log(f"backward check {shape}: stashed forward operands vs plain recompute max|d| {d:.6g} "
            f"<= bar {bar:.6g}, corr {corr:.7f}, relu-mask flips {flips:.3g} (<= 1e-3)")
        # the dense forwards share the data kernel's tile and program: their
        # output is lin_out of the stashed t (in f64, up to the f32 rounding
        # of its own lin_out) if the recompute took the primal's products
        # and folds in the primal's order; the plain recompute's t, summed
        # otherwise, for scale
        with torch.no_grad():
            out_f = (rf.resnetfc_dense(z, x, tw, nb) if NS == 1
                     else rf.resnetfc_dense_mv(z, x, tw, nb, NS, cl, sb)).double()
            wo, bo = tw.w_out.double(), tw.b_out.double()[:, None]
            d_stash = (out_f - ((data.ws_act[-1, :B].double() @ wo).t() + bo)).abs().max().item()
            d_plain = (out_f - ((ops_p[-1].double() @ wo).t() + bo)).abs().max().item()
        same_order = d_stash <= 1e-5 * max(1.0, out_f.abs().max().item())
        ok = ok and same_order
        fwd_name = "resnetfc_fwd_dense" if NS == 1 else "resnetfc_fwd_dense_mv"
        log(f"backward check {shape}: {fwd_name}'s output vs lin_out of the stashed t "
            f"(f64) max|d| {d_stash:.3g}, vs lin_out of the plain recompute's t {d_plain:.3g}: "
            f"the recompute sums in the primal's order {same_order}")
        if NS > 1:
            records["resnetfc_fwd_dense_mv"].setdefault("recompute_in_primal_order", {})[
                f"{sb}x{B_obj}"] = same_order
        del out_f
        same = rv.resnetfc_bwd_reference(g, z, x, tw, nb, True, torch.bfloat16, operands=ops_k,
                                         **kw)
        ind = rv.resnetfc_bwd_reference(g, z, x, tw, nb, True, torch.bfloat16, **kw)
        del ops_k, ops_p
        err = {"resnetfc_bwd_data": 0.0, "resnetfc_bwd_weights": 0.0}
        for name in rv.Grads._fields:
            out = getattr(gr, name).float()
            d1, bar1, c1 = agree(out, getattr(same, name))
            d2, bar2, c2 = agree(out, getattr(ind, name))
            fine = (d1 <= bar1 and c1 > 0.999 and (c2 > 0.999 or NS > 3)
                    and bool(torch.isfinite(out).all()))
            ok = ok and fine
            # dz and dx come from the data kernel; the weights kernel reduces
            # every weight and bias gradient
            owner = "resnetfc_bwd_data" if name in ("dz", "dx") else "resnetfc_bwd_weights"
            err[owner] = max(err[owner], d1)
            log(f"  {name} {tuple(out.shape)}: vs plain on the same operands max|d| {d1:.6g} <= "
                f"bar {bar1:.6g}, corr {c1:.7f}; vs independent plain max|d| {d2:.6g} "
                f"(bar {bar2:.6g}), corr {c2:.7f}{' (not gated past -V 3)' if NS > 3 else ''}"
                f"{'' if fine else '  FAILED'}")
        del same, ind
        # the weights kernel alone against its plain version on its own DataOut
        wref = rv.bwd_weights_reference(z, data, tw, nb)
        for name in ("w_in", "b_in", "w_z", "b_z", "w_blk", "b_blk", "w_out", "b_out"):
            out = getattr(gr, name).float()
            d1, bar1, c1 = agree(out, getattr(wref, name))
            fine = d1 <= bar1 and c1 > 0.999
            ok = ok and fine
            err["resnetfc_bwd_weights"] = max(err["resnetfc_bwd_weights"], d1)
            log(f"  {name}: resnetfc_bwd_weights vs bwd_weights_reference on the same DataOut "
                f"max|d| {d1:.6g} <= bar {bar1:.6g}, corr {c1:.7f}{'' if fine else '  FAILED'}")
        del wref
        gr2 = rv.bwd_weights(z, rv.bwd_data(g, z, x, tw, nb, True, **kw), tw, nb)
        identical = all(torch.equal(getattr(gr, n), getattr(gr2, n)) for n in rv.Grads._fields)
        del gr2
        if ragged:
            plan = rv.weight_plan(tw.w_in.shape[0], H, C, nb, n_lin_z, NS, data.pre, B,
                                  rv.kernel_limits(H), n_sm)
            log(f"backward check {shape}: bit-identical on a second call {identical}; "
                f"resnetfc_bwd_weights sums its longest product's {data.ws_x.shape[0]} points "
                f"in {max(plan.table[4::6])} splits of {plan.pts}")
            if not (ok and identical):
                raise SystemExit(f"backward kernel check failed at {shape}")
            for name, e in err.items():
                records[name]["max_abs_err"] = max(records[name].get("max_abs_err", 0.0), e)
            del data, gr, g, x, z, idx, w, pts, vd
            continue
        data_ms = cuda_ms(lambda: rv.bwd_data(g, z, x, tw, nb, False, **kw), 5)
        weights_ms = cuda_ms(lambda: rv.bwd_weights(z, data, tw, nb), 5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):  # the wrapper's host time a call (launch included), no sync
            rv.bwd_weights(z, data, tw, nb)
        weights_host_ms = (time.perf_counter() - t0) / 5 * 1e3
        torch.cuda.synchronize()
        rv._PARAMS.clear()  # once more with the tensor maps encoded anew
        t0 = time.perf_counter()
        rv.bwd_weights(z, data, tw, nb)
        weights_host_new_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        # the weights kernel at other splits of the point axis than the wrapper's
        kin, P_max = tw.w_in.shape[0], data.ws_x.shape[0]
        lim = rv.kernel_limits(H)
        chosen = rv.weight_plan(kin, H, C, nb, n_lin_z, NS, data.pre, B, lim, n_sm)
        sweep = {}
        for S in (1, 2, 3, 4, 6, 8, 12, 16, 24):
            plan = rv.weight_plan(kin, H, C, nb, n_lin_z, NS, data.pre, B, lim, n_sm,
                                  pts=-(-P_max // (64 * S)) * 64)
            ctas = sum(plan.table[6 * i + 4] * rv.weight_tiles(t, H, lim) for i, t in
                       enumerate(rv.weight_tasks(kin, H, C, nb, n_lin_z, NS, data.pre, B)))
            ms = cuda_ms(lambda: rv._launch_weights(z, data, plan, kin, H, C, nb, n_lin_z,
                                                    d_out), 5)
            sweep[S] = (plan.pts, ctas, ms)
        log(f"backward check {shape}: resnetfc_bwd_weights by splits of the longest product "
            f"(points a split, CTAs, ms): {json.dumps(sweep)}; the wrapper's choice "
            f"{chosen.pts} points (one view's), fastest "
            f"swept {min(sweep.values(), key=lambda v: v[2])[0]} points")
        plain_ms = cuda_ms(lambda: rv.resnetfc_bwd_reference(g, z, x, tw, nb, False,
                                                              torch.bfloat16, **kw), 2)
        # each kernel's own plain version: the workspace in plain form, and
        # the weight products over the kernel's DataOut
        plain_data_ms = cuda_ms(lambda: rv.workspace_reference(g, z, x, tw, nb, **kw), 2)
        plain_weights_ms = cuda_ms(lambda: rv.bwd_weights_reference(z, data, tw, nb), 2)
        # the weights kernel's yardstick: one cuBLAS bf16 A^T G per product
        # over the same planes (the port never calls it)
        w_ops = [rv.task_operands(t, z, data)
                 for t in rv.weight_tasks(tw.w_in.shape[0], H, C, nb, n_lin_z, NS, data.pre, B)]
        library_weights_ms = cuda_ms(
            lambda: [torch.matmul(a.t(), gg[: a.shape[0]]) for a, gg in w_ops], 5)
        del w_ops
        leaves = [t.detach().bfloat16().requires_grad_() for t in tw[:8]]
        with torch.enable_grad():
            if NS == 1:
                zl = z.detach().requires_grad_()
                lout = library_tower(zl, x, rf.Tower(*leaves, tw.d_in, tw.d_hidden), nb)
            else:
                zl = by_view(z, NS, sb).detach().requires_grad_()
                lout = library_tower_mv(zl, by_view(x, NS, sb),
                                        rf.Tower(*leaves, tw.d_in, tw.d_hidden), nb, NS, cl)
        library_ms = cuda_ms(
            lambda: torch.autograd.grad(lout, [zl, *leaves], g, retain_graph=True), 5)
        del lout, leaves, zl
        f_pt = flops_pt if NS == 1 else flops_mv(NS)  # forward FLOP per output point
        ws = sum(t.numel() * t.element_size()  # the bf16 workspace, written once, read once
                 for t in (data.ws_act, data.ws_cot, data.ws_x, data.ws_z) if t is not None)
        io_bytes = rows * (C * 2 + d_in * 4) + B * d_out * 4 + w_bytes
        # timed without dx (as the train step asks the data kernel)
        d_pt = data_flops_pt(f_pt, H, NS, d_in, False)
        b_data = bound(B * d_pt, io_bytes + ws + rows * C * 4)
        z_read = rows * C * 2 if data.ws_z is None else 0  # z in place at NS = 1, else ws_z
        b_weights = bound(B * f_pt, ws + z_read + 2 * w_bytes)
        b_fn, b_fn_by = bound(B * (d_pt + f_pt), io_bytes + rows * C * 2 + 2 * w_bytes)
        bwd_ms[(NS, K)] = data_ms + weights_ms
        weights_ms_at[(NS, K)] = weights_ms
        with torch.no_grad():
            fwd_ms[(NS, K)] = cuda_ms(
                (lambda: rf.resnetfc_dense(z, x, tw, nb)) if NS == 1
                else (lambda: rf.resnetfc_dense_mv(z, x, tw, nb, NS, cl, sb)), 5)
        w_tflops = B * f_pt / weights_ms / 1e9
        log(f"backward check {shape}: bit-identical on a second call {identical}; kernel_ms data "
            f"{data_ms:.4f} + weights {weights_ms:.4f} = {bwd_ms[(NS, K)]:.4f}, plain_ms "
            f"{plain_ms:.4f}, library_ms {library_ms:.4f} (autograd backward of the cuBLAS chain), "
            f"bound_ms {b_fn:.4f} ({b_fn_by}; data {b_data[0]:.4f} {b_data[1]}, weights "
            f"{b_weights[0]:.4f} {b_weights[1]}); workspace {ws / 2**30:.3f} GiB; the forward "
            f"kernel at this shape {fwd_ms[(NS, K)]:.4f} ms")
        log(f"backward check {shape}: resnetfc_bwd_weights {weights_ms:.4f} ms = {w_tflops:.1f} "
            f"TFLOP/s, {b_weights[0] / weights_ms:.3f} of its bound ({b_weights[0]:.4f} ms); "
            f"plain_ms {plain_weights_ms:.4f}; library_ms {library_weights_ms:.4f} (cuBLAS bf16 "
            f"A^T G per product over the same planes); host {weights_host_ms:.4f} ms a call "
            f"({weights_host_new_ms:.4f} with its tensor maps encoded anew)")
        d_tflops = B * d_pt / data_ms / 1e9  # the recompute and the data gradients
        # the weight bytes the data kernel streams from L2: every 64-point tile
        # reads each weight matrix of its products once forward and once back
        kin = tw.w_in.shape[0]
        pre_d = data.pre if NS > 1 else nb
        tile_w = 2 * H * 2 * (NS * (kin / 2 + n_lin_z * C + 2 * pre_d * H) + 2 * (nb - pre_d) * H)
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        w_tbs = -(-data.ws_x.shape[0] // NS // 64) * tile_w / data_ms / 1e9
        log(f"backward check {shape}: resnetfc_bwd_data {data_ms:.4f} ms = {d_tflops:.1f} TFLOP/s, "
            f"{b_data[0] / data_ms:.3f} of its bound ({b_data[0]:.4f} ms, {b_data[1]}); plain_ms "
            f"{plain_data_ms:.4f} (workspace_reference); library_ms {library_ms:.4f} (autograd "
            f"backward of the cuBLAS chain); weights streamed from L2 {tile_w / 2**20:.2f} MiB a "
            f"64-point tile, {w_tbs:.3f} TB/s = {w_tbs * 1e3 / n_sm:.2f} GB/s an SM")
        if not (ok and identical):
            raise SystemExit(f"backward kernel check failed at {shape}")
        for name, ms, (b_ms, b_by), p_ms, l_ms in (
                ("resnetfc_bwd_data", data_ms, b_data, plain_data_ms, library_ms),
                ("resnetfc_bwd_weights", weights_ms, b_weights, plain_weights_ms,
                 library_weights_ms)):
            rec = records[name]
            rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), err[name])
            if K == 96:  # times at the fine pass's shape; -V 3 beside -V 1
                t = dict(ms=ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=l_ms,
                         plain_backward_ms=plain_ms, share_of_bound=b_ms / ms)
                if name == "resnetfc_bwd_weights":
                    t.update(tflops=w_tflops, chain_library_ms=library_ms,
                             host_ms=weights_host_ms)
                else:
                    t.update(tflops=d_tflops, weight_stream_tb_s=w_tbs, design="64-point tiles on wgmma m64n128k16, "
                             "weights by TMA through a 3-stage mbarrier ring")
                if NS == 1:
                    rec.update(name=name, route="cuda",
                               source="pixelnerf_tpu_torch/csrc/resnetfc_bwd.cu",
                               replaces="pixelnerf_tpu/ops/resnetfc_vjp.py:172", **t)
                else:
                    rec[f"ns{NS}"] = dict(t, points=B, rows=rows, max_abs_err=err[name])
        del data, gr, g, x, z, idx, w, pts, vd

    # ---- train-step parity: kernel route (AMP) vs plain f32 route, -V 1 and -V 3 ----
    from pixelnerf_tpu_torch.data import get_split_dataset

    ds = get_split_dataset("synthetic", "", want_split="train")
    n_rays = 4 * 128
    for nviews in (1, 3):
        log(f"train-step parity: sn64 full width, the weights of the render phases (seeded, "
            f"random encoder, live fc_1), -F synthetic {len(ds)} objects x {ds.n_views} views at "
            f"{ds.image_size}px, one prepare_ray_batch batch at B 4, V {nviews}, R 128, shared "
            f"draws")
        step_parity(conf, net.state_dict(), nviews, dev, "")

    # ---- data: fixtures written by the port's writers, read back by its adapters ----
    data_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_data_")
    try:
        nmr_root, dtu_root = data_phase(data_dir.name, smi)
        sn64_step_ms = train_eval_paths(nmr_root, dtu_root, net, smi, records, code_records,
                                        bwd_ms, weights_ms_at, fwd_ms, n_rays)

        # ---- the occupancy accel on a quick-trained field ----
        code_accel_launches = accel_phase(conf, dev, smi, records, code_records)

        # ---- the multi-scale recipe (reads the NMR fixture) ----
        multiscale_phase(conf, net, src3, rays, dev, smi, records, code_records, nmr_root,
                         sn64_step_ms)

        # ---- the remaining eval CLIs on the fixtures ----
        eval_cli_phase(net, dev, smi, records, code_records, nmr_root, dtu_root)

        # ---- the fork's remaining model options (reads the NMR fixture) ----
        options_phase(conf, src, src3, rays, dev, smi, records, code_records, nmr_root,
                      dtu_root)

        # ---- narrow towers on the forward kernels (reads the NMR fixture) ----
        narrow_phase(conf, net, src, src3, rays, dev, smi, records, code_records, nmr_root)
        wide_phase(conf, net, src, src3, rays, dev, smi, records, code_records, nmr_root)

        # ---- narrow towers on the backward kernels (reads both fixtures) ----
        narrow_backward_phase(conf, dev, smi, records, nmr_root, dtu_root)

        # ---- the train CLI's visuals and the utilities (reads both fixtures) ----
        visuals_phase(dev, smi, records, code_records, nmr_root, dtu_root)

        # ---- several ranks on the card (reads the NMR fixture) ----
        multichip_phase(smi, records, code_records, nmr_root)

        # ---- ResNet50's latent on the kernels (reads both fixtures) ----
        resnet50_phase(conf, net, src, src3, rays, dev, smi, records, code_records, nmr_root,
                       dtu_root)
    finally:
        data_dir.cleanup()

    # row 6 as one record: the single-view gather variant's numbers (the
    # 1-view deferred render's kernel) at the top, every variant under
    # "variants"; launches are the deferred renders' (phase 7)
    records["resnetfc_fwd_code"] = dict(
        code_records["resnetfc_fwd_gather_code"], name="resnetfc_fwd_code",
        route="cuda", source="pixelnerf_tpu_torch/csrc/resnetfc_fwd.cu",
        replaces="pixelnerf_tpu/ops/resnetfc_pallas.py:156",
        launches=sum(r["launches"] for r in code_records.values()),
        max_abs_err=max(r["max_abs_err"] for r in code_records.values()),
        variants=code_records, accel_launches=code_accel_launches)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(f"done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [dict({k: records[n][k] for k in keys},
                                       **{k: v for k, v in records[n].items() if k not in keys})
                                  for n in records]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
