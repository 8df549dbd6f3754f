#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port of FSNet (``fsnet_tpu_torch``) on one NVIDIA
GPU and checks it: the quickest proof that the port starts on the card.

    python3 chip_smoke.py          # from the root of a checkout, one GPU
    python3 chip_smoke.py --conv-repeats 500   # phases 8, 17 launch each
                                               # conv kernel 500 times

Phases, in order; any failure ends the run with a non-zero exit code:

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. builds the kernels from ``fsnet_tpu_torch/csrc`` (nvcc, sm_90a, one
   process per source, all together) and prints the build time and the
   compiler's register/spill report of each kernel by name; checks that
   the SASS of both conv libraries holds tensor-core (``HMMA``) and
   asynchronous-copy (``LDGSTS``) instructions (``cuobjdump -sass``; the
   run fails where the toolkit has no cuobjdump), that kernel E's library
   holds 16-byte global loads and stores and kernel K's vector float
   reductions (``RED`` of 4 floats), the instructions of their
   channel-wide routes, that the vector routes of the projecting warps A
   and G at C = 3 and the row routes of the grid warps F at C = 3 and E at
   C = 1 hold 128-bit global stores (``STG.E.EF.128``; their narrow
   kernels' stores are counted beside them), and that the photometric
   kernels' vector route (I and J at C = 3) holds 16-byte asynchronous
   copies (``LDGSTS``) and 128-bit global loads and stores;
   prints each photometric kernel's registers and spills (ptxas) and its
   counts of those instructions, shuffles and FP32 instructions, in all
   and in each stretch of code after one of its barriers;
3. turns TF32 off for matrix products and cuDNN convolutions, so every
   float32 number on the card (the encoder's convs included) is full
   float32;
4. holds the conv3x3 kernel against its plain version at each of the
   decoder's 14 conv shapes at batch 12 x 192x640, in float32 and bfloat16
   (max |kernel - plain| / max |plain| <= 1e-4 and 2e-2), and its bfloat16
   input cotangent (<= 2e-2);
5. the eval path: builds the flagship ``MonoDepthWPose`` (ResNet-18 +
   16-bin MultiChannelDepthDecoder, seeded random weights) on the card and
   runs one ``forward_test`` through ``make_eval_step`` at batch 12 x
   192x640, float32, with the launch counters set to 0 just before; checks
   that the decoder's convs ran at the 14 shapes of phase 4, each through
   the kernel (14 launches, no other kernel), and that depth is finite,
   [12, 192, 640, 1] and within [0.5, 100];
6. runs the same weights and input at batch 2 on the card and through the
   port on the CPU (plain versions) and compares depth (rel-max <= 1e-3);
7. times, with CUDA events after warm-up, ``forward_test`` at batch 1
   (latency) and batch 12 (images/s), and at each conv shape the kernel
   beside its two bounds (float32 CUDA cores; 3xTF32 tensor cores, the
   kernel's route), its plain version and ``F.conv2d`` (cuDNN, the same
   function at the 5 one-part zero-padded shapes; a yardstick only, the
   port never calls it for these convs);
8. holds the training kernels against their plain versions at the shapes
   the train step gives them at batch 12 x 192x640: the conv's moments
   epilogue at the 10 upconv shapes, the input cotangent (the conv
   kernel's cotangent mode) and the weight cotangent at all 14 (max error /
   max |plain| <= 2e-5 for out, s2, dx and dw; s1 against the sum of
   |out|), each kernel launched 4 times per shape (``--conv-repeats``),
   the outputs that no atomic add touches (the stored out, dx) bitwise
   equal launch to launch; a miss saves its inputs and worst elements
   beside a float64 reference under ``build/conv_faults/`` and prints
   where it lies; then the depth-direct warp forward through the public
   wrapper (the vector route that ``proj_route`` picks there; out, va, vb
   and the overlap bitwise equal to the plain version) and backward (<=
   1e-6 relative) at 96 warps (4 scales x 2 frames x 12), and kernel A
   launched 4 times on each route in turns (vector, narrow, narrow,
   vector, ...), every launch bitwise equal to the plain version; prints
   how many samples the TPU kernel's lane-window clamp would have moved
   there;
9. the train path: ``flagship_model(..., device="cuda")`` with the
   ``bench.py`` recipe (Adam lr 1e-4, clip 1.0, StepLR) and
   ``make_train_step("cuda")``, three steps at batch 12 x 192x640 on the
   synthetic KITTI-like batch, the launch counters set to 0 just before;
   checks the launches of every kernel per step (the conv kernel 4 times
   forward, 10 with moments and 14 times for the input cotangents, one
   launch per conv for both parts; the weight-cotangent kernel 14), kernel
   A's 3 launches all on the vector route (route counters), a finite loss,
   and that parameters and BN running statistics changed;
10. one train step at batch 2 x 192x640 on the card against the port on the
    CPU from the same weights and batch, held to the JAX package's own
    backward gate between two routes (``scripts/tpu_smoke.py``): loss rel
    <= 1e-4, global gradient rel-L2 < 3e-2, every leaf < 0.5 (the worst is
    printed), and Adam's first update differing by more than lr / 2 on
    under 2% of the parameters. In float32 the two sides' decoder outputs
    differ by about 1e-6 (cuDNN and the kernels against the CPU), which
    moves bilinear corners of the warp wherever a coordinate lies that
    close to an integer; each such sample moves the gradient of its pixel
    by O(1);
11. times the train step at batch 12 (images/s over 10 steps after
    warm-up; the batch on the card, as ``bench.py`` times the JAX step, and
    again from host numpy arrays) and each training kernel at its shapes
    (kernel A on both routes in turns: vector, narrow, narrow, vector)
    beside its plain version, its bound (the conv kernels: both bounds, as
    phase 7) and, where one PyTorch call computes the same function, that
    call (cuDNN's conv backward for the single-part zero-padded convs; a
    yardstick only);
12. holds the grid warp's kernels against their plain versions at the grid
    route's shapes at batch 12: 96 reprojection grids @192x640 (4 scales x
    2 frames x 12) against the 24 source frames for kernel F (bilinear,
    border, C=3: out, va, vb) and against the 12 patched masks for kernel E
    (nearest, zeros, C=1), through the public wrappers (the row route that
    ``warp_route`` picks there) with max abs err <= 1e-6 and the ``== 1.0``
    overlap equal, then each launched 4 times on the row and the narrow
    route in turns (row, narrow, narrow, row, ...), every launch bitwise
    equal to the plain version; the same at the NuScenes recipe's shape,
    batch 8 x 288x512 (64 grids, the synthetic batch's ``"nuscenes"``
    patched mask); prints at both how many samples the TPU kernel's
    lane-window clamp would have moved (at W = 512 it can);
13. the grid route of the flagship: three train steps at batch 12 x
    192x640 on the synthetic batch with an all-ones ``patched_mask`` (as
    every dataset batch carries one), the launch counters set to 0 just
    before; checks per step kernel F 1 launch and kernel E 1, both on the
    row route (route counters), the depth-direct
    kernels 0 and the conv kernels as in phase 9, a finite loss and changed
    parameters and BN statistics; then one step from the same weights with
    and one without the mask (the depth-direct route): loss rel <= 1e-4 and
    global gradient rel-L2 < 3e-2 between the two routes;
14. the learned-pose ``MonoDepthMeta``: three train steps at batch 12, the
    counters set to 0 just before; per step kernel F 1 launch (on the row
    route), kernel E 0, the depth-direct kernels 0, the conv kernels as in
    phase 9; a finite loss and changed pose parameters;
15. one ``MonoDepthMeta`` step at batch 2 on the card against the port on
    the CPU, held to phase 10's gate;
16. times both grid-route steps at batch 12 (images/s over 10 steps after
    warm-up, the batch on the card) and kernels E and F on both routes in
    turns (row, narrow, narrow, row), at phase 12's two scenes, beside
    their plain versions and bounds (``F.grid_sample``, another function
    without the band, is timed beside them as a yardstick only);
17. the KITTI-360 fisheye recipe (bs 16 @ 384x384, Mei camera, band 16):
    holds kernels G (the norm-direct warp with its mask pass) and H (the
    norm cotangent) against their plain versions on the fisheye batch's
    rays, camera and poses at 128 warps against 32 sources and 16 masks
    (out, va, vb and the overlap bitwise equal, on the vector route, d norm
    rel <= 1e-6), then G launched 4 times on each route in turns, every
    launch bitwise equal to the plain version; prints how many samples
    have a corner row outside the band
    (all, and those with a valid ray), in how many rows the pixels outside
    the fisheye disc pull the band start down, and how many samples the TPU
    lane-window clamp would move (none can at W = 384), and holds the conv
    kernels (forward, moments, dx, dw) against their plain versions at the
    14 decoder shapes of 384x384, batch 16, repeated as in phase 8;
18. ``forward_test`` of ``fisheye_model`` at batch 16 through
    ``make_eval_step``: 14 conv launches and no other kernel, finite
    z-depth, norm and fisheye mask of the right shapes, the norm within
    [0.1, 150] and the mask the ray map's;
19. three fisheye train steps at batch 16, the counters set to 0 just
    before: per step kernels G and H 1 launch each (G on the vector route),
    A, B, E and F none, the conv kernels as in phase 9; a finite loss and
    changed parameters and BN statistics;
20. one fisheye step at batch 2 on the card against the port on the CPU,
    held to phase 10's gate; then one step at batch 16 from the same
    weights on the norm-direct route (G, H) and one on the fisheye grid
    route (F, E at band 16, forced by leaving out the marker of dataset
    poses; both on the row route): loss rel <= 1e-4 and global gradient
    rel-L2 < 3e-2;
21. times the fisheye step at batch 16 (images/s over 10 steps, the batch
    on the card) and kernels G (both routes in turns: vector, narrow,
    narrow, vector) and H beside their plain versions and bounds
    (``F.grid_sample`` at the Mei grid as a yardstick only);
22. checks from the route counters that every photometric train path
    (phases 9, 13, 14, 19) ran the forward, kernel I, twice and the
    prediction cotangent, kernel J, once per step, all on the vector route
    (``csrc/photo_loss.cu``); prints the vector route's dynamic shared
    memory and resident blocks per SM (by the runtime's occupancy query);
    holds both routes of I and J against their plain versions on the loss's
    own operands at both recipes: the warped stack (phase 8's depth-direct
    warp of the synthetic batch's clipped textures, 96 warps @192x640;
    kernel G's 128 warps @384x384) and the identity stack (24 and 32
    sources) against the 12 and 16 targets. The forward bitwise on the
    vector route and within 1e-6 of the largest loss on the narrow one (the
    share of bitwise-equal pixels printed), the cotangent of the warped
    stack within 1e-5 of its largest entry against the plain cotangent (the
    vector route bitwise) for each of 4 seeded loss cotangents, and against
    autograd of the plain forward on the card at the first (the plain
    cotangent and autograd round apart by about 1e-5 of the largest entry
    themselves; every error printed);
    prints the exact ties each stack holds (zero variance, SSIM
    dissimilarity at 0 and at 1, pred == target), and times both routes of
    both kernels in turns (vector, narrow, narrow, vector) beside their
    plain versions, bounds and issue floors (FP32 instructions per
    pixel-channel, worked out from phase 2's SASS of this run, over 128
    lanes per SM at the SM's top clock), summed over one step's launches
    at each recipe, and the host's time to issue one call of each public
    wrapper (vector route) and of the narrow route's launcher.

23. the DLA path: ``dla_model`` (``dlanet(34)`` under ``DLASegUpsample``,
    seeded weights, every offset conv perturbed so that the offsets spread
    by about 1.5 px) at batch 12 x 192x640: at each of its 16 deformable
    convs, the input and the 9-tap grid of a train-mode forward, kernel E
    (bilinear, zeros, band 8) against its plain version (max abs err
    <= 1e-6, and bitwise equal) and kernel K (``csrc/warp_grad.cu``: gfx,
    gfy and the image cotangent) against its plain version (within 1e-5 of
    each one's largest entry), each launched 4 times: E bitwise and K's
    gfx, gfy bitwise launch to launch; prints the route each took (both
    must take the channel-wide one) and how many samples fall outside the
    band of 8 rows;
24. the DLA serving forward (``train=False``) through ``make_eval_step``,
    the counters set to 0 just before: E 16 launches (one per DCN, its
    taps batched), all on the channel-wide route, K and every other kernel
    none; the output [12, 48, 160, 64] finite;
25. three DLA train steps (the loss ``sum(out * target_weight)``, the
    ``bench.py`` recipe), the counters set to 0 just before: per step E 16
    and K 16, all on the channel-wide route, nothing else; a finite loss
    and changed parameters and BN
    statistics; then one step at batch 2 on the card against the CPU port
    with every BN on its init statistics (``dla_model(norm_frozen=True)``),
    held to phase 10's gate; and, as a reading with only the loss held to
    1e-4, the train-mode step at batch 2 on the card against the CPU port
    and the CPU port's float32 step against its float64 step (float32
    rounding alone moves that gradient by several percent:
    ``scripts/dla_conditioning.py``);
26. times E and K at each of the 16 DCN shapes (by CUDA events over 10
    back-to-back calls, beside the host's time to issue one call and the
    shape's bound) and summed over the 16 DCNs of one step beside their
    plain versions, bounds and yardsticks (``F.grid_sample`` and
    ``grid_sampler_2d_backward``, exact, without the band), then the DLA
    step at batch 12 (10 steps, the batch on the card; its peak memory)
    and its forward.

27. the nuScenes ``nusc_wpose`` recipe (``entry.nusc_model``: ResNet-34,
    64 bins, ``base_fx=369``, ``overlapped_mask=False``; ``NUSC_RECIPE``:
    StepLR step 4): three train steps at batch 8 x 288x512 on
    ``entry.nusc_batch`` (the ``"nuscenes"`` patched mask, so the grid
    route), the counters set to 0 just before: per step conv3x3 4,
    conv3x3_bn 10, dx 14, dw 14, kernel F 1 (row route), I 2 and J 1
    (vector route) and kernel E none (without the overlap mask the head
    warps no mask); a finite loss, changed parameters and BN statistics;
    prints how many samples the TPU lane-window clamp would move on the
    grids of the last step's own depths (W = 512);
28. the conv kernels against their plain versions at every distinct conv
    shape of the two nuScenes steps, batch 8 (the 10 upconvs, the 64- and
    16-bin dispconvs and the one-channel uncertainty convs: forward,
    moments at the upconvs, dx and dw, phase 8's gates, repeated as
    there), the template arguments of the kernel each wrapper launches at
    Co = 64 and Co = 1 (read by ``torch.profiler``; at Co = 1 no 16-byte
    copies), and kernels I and J against their plain versions on the
    nusc_wpose step's own operands (its warped stack, kernel F's output of
    phase 27's last step, and its sources), as phase 22 holds them, with
    autograd of the plain forward as a reading;
29. the ``distill_nusc`` recipe (``entry.distill_model``: a frozen
    ResNet-18/16-bin teacher grafted from a seeded ``MonoDepthWPose``
    through ``runtime.checkpoint``, a ResNet-18 student with
    ``MultiChannelDepthDecoderUncertain``, the uncertainty-weighted
    distillation loss at 0.3, the overlap mask): three train steps at
    batch 8 x 288x512, the counters set to 0 just before: per step
    conv3x3 22 (the student's 4 dispconvs and 4 uncertainty convs, the
    teacher's 14 in eval mode), conv3x3_bn 10, dx 18, dw 18, F 1 and E 1
    (row route), I 2 and J 1; the teacher's parameters and BN statistics
    bitwise unchanged and out of the optimizer, every student parameter
    moved, the four ``distilation/{s}`` terms finite; the lane-window
    count on the last step's depths;
30. one step of each recipe at batch 2 x 288x512 on the card against the
    port on the CPU, held to phase 10's gate;
31. times both steps at batch 8 (images/s over 10 steps after warm-up,
    the batch on the card; device-busy ms a step under ``torch.profiler``
    over 3 steps; peak memory) and each conv kernel at the shapes of phase
    28 beside its plain version, its two bounds and, at the one-part
    zero-padded shapes, cuDNN's call of the same function, summed over
    each step's launches;
32. the bf16 forms against their plain versions on the card, each
    launched 4 times (``--conv-repeats``): the moments kernel at the 10
    upconv shapes of the bs12 step (the stored bf16 output within one bf16
    ulp of the plain one beyond 2e-5 of its largest entry and bitwise
    launch to launch, the float32 moments within phase 8's gates of the
    sums of that stored output: a one-ulp rounding flip of a stored value
    moves a sum over 1,440 pixels by about 5e-6 of it)
    and the weight cotangent on bf16 operands at all 14 (float32, phase
    8's gate), phase 8's trap saving a miss; kernels I and J on the
    depth-direct step's bf16 warped and identity stacks (bitwise equal to
    the plain versions, J also to its float32 form on the widened operands
    rounded, which is within 1e-5 of the float32 plain cotangent); the
    warps A, B (depth-direct) and F, E (the mask) through their wrappers on
    bf16 images (A, F, E bitwise; B's bf16 form, gfx and gfy formed in the
    kernel, within 1e-6); prints each bf16 kernel's
    registers, spills and shared memory (ptxas) and the photometric
    kernels' occupancy at bf16;
33. one bf16 step of each flagship route through ``make_train_step`` with
    the recipe's ``compute_dtype``, the counters set to 0 just before: the
    launches of phases 9 and 13, the conv and photometric kernels on bf16
    operands (the wrappers' counts by dtype), the routes as at float32,
    bf16 warped frames into the loss; the lane-window count on the step's
    own depths;
34. one bf16 step at batch 2 x 192x640 of each route on the card and
    through the port on the CPU, on the synthetic batch's own textures,
    held to the JAX package's bf16 gates: loss rel < 2e-2, which the card's
    float32 step (the control) must miss; the card's bf16 gradients against
    the CPU port's, global rel-L2 < 0.3 and worst leaf < 0.6 (the
    control's read beside them, and gated to miss); gradient cosine
    against the card's float32 step > 0.25;
    every gradient leaf on the card bf16-valued; prints the bf16/f32 loss
    ratio;
35. times the flagship step at batch 12 in float32 and in bf16 on both
    routes as ``bench.py`` times the JAX step (the batch on the card, 3
    warm-up steps, one window of 20 steps, where bench.py takes the
    fastest of 4; device-busy ms under ``torch.profiler``; peak memory), and
    each bf16 form at the step's shapes beside its float32 form, its
    bounds at bf16 bytes and, at the 5 one-part zero-padded conv shapes,
    cuDNN in bf16; the warps through their wrappers on bf16 images,
    widening and rounding passes included, beside their float32 kernels
    alone;
36. kernels G and H in bfloat16 against their plain versions at the
    fisheye recipe's shape, beside a float32 norm (the bf16 step's) and a
    bfloat16 one: G on both routes 4 times each in turns, out, va, vb and
    the overlap bitwise; H 4 times within 1e-6 of the largest entry (one
    bf16 ulp beyond that where d norm is bfloat16); and the conv kernels'
    bfloat16 forms at the distillation step's four one-channel
    uncertainty convs (forward and input cotangent within one bf16 ulp
    beyond 2e-5 and bitwise launch to launch, the weight cotangent within
    2e-5), 4 launches each;
37. one bf16 step of the fisheye (bs16 @384x384), ``nusc_wpose`` and
    ``distill_nusc`` (bs8 @288x512) recipes through ``make_train_step``
    with each recipe's ``compute_dtype`` and optimizer, the counters set
    to 0 just before: the launches of its float32 step (phases 19, 27,
    29), every kernel with a bf16 form (conv, G, H, I, J) on bf16
    operands (the mask's E, on the row route, on its float32 kernel), the
    routes as at float32, bf16 warped frames into the loss,
    the distillation teacher bitwise unchanged, the lane-window count on
    the step's own depths;
38. one bf16 step of each at batch 2 on the card and through the port on
    the CPU, on smooth textures, held to phase 34's loss gates (the card's
    float32 step the control that must miss; the distillation step's loss
    less its distillation terms, which would drown the photometric loss)
    and cosine, with the
    gradients held below the control's distances (global rel-L2 under
    3/4 of the control's, the worst leaf under the control's worst);
39. times each recipe's step at its batch in float32 and in bf16 as phase
    35 times the flagship's, and kernels G and H in bf16 on the step's
    operand types (G on both routes) beside their float32 kernels on the
    same values, their plain versions and their bounds at bf16 bytes;
40. the flagship recipe trained from its dataset through the port's
    ``scripts/train.py`` ``main`` on ``configs/synthetic_flagship.py``
    (``configs/kitti_wpose_example.py``'s recipe on the synthetic dataset
    rendered at 375x1242: bf16, bs12 @192x640, the train augmentation
    graph, 4 loader workers) with 36 samples (3 steps an epoch) for 2
    epochs, then resumed from its ``_latest`` checkpoint for one more; the
    counters set to 0 just before each step and read just after: every
    step's launches, launches by dtype and routes equal phase 33's
    grid-route bf16 step's; each loss finite; the tie-break noise different
    at every step; ``_latest`` equal to the trained model and optimizer
    bitwise, and the resumed run's model and optimizer (parameters, BN
    statistics, mu, nu, count) equal to it bitwise at its first step, whose
    learning rate is ``schedule(count)``; then ``scripts/test.py``'s
    ``main`` on the resumed run's checkpoint over 4 val samples: 14
    conv3x3 launches a sample and nothing else, the depth finite and within
    [min_depth, max_depth];
41. readings, beside the card's name and power limit: ``dataset[i]``
    alone (ms a sample), the loader alone (4 workers, ms a batch over the
    last 6 of an epoch of 10), the loop (``train.main``, one epoch of 10
    steps): step wall, loader wait and imgs/s over the last 6 steps, and
    its first step apart, the epoch-boundary reading that phase 40's
    epochs of 3 steps also give; and phase 35's grid-route bf16 step with
    the batch on the card;
42. the port's PNG reader: its C unfilter (built by ``cc`` at first use)
    bitwise equal to its plain version, and both to the samples written,
    on 375x1242 8-bit RGB, 8-bit grey, 16-bit grey and 16-bit RGB files
    whose rows cycle through the five PNG filters (written by
    ``tests/disk_trees.py``: numpy filters and zlib, no cv2 or PIL on the
    card machine) and on ``meta_data/kitti360_trainsub/fisheye_mask.png``;
    readings: the build, one RGB frame's and one 16-bit depth map's read,
    and ``dataset[i]`` of a written KITTI raw tree (375x1242, the
    flagship's train augmentation) beside ``sample_ms`` of the synthetic
    render, in turns;
43. the KITTI raw recipe from that tree: the ground truth of its 24
    Eigen-style test frames projected from their velodyne scans into a
    ``.npz`` in the tree; ``scripts/train.py``'s ``main`` on the port's
    ``configs/kitti_wpose_example.py`` (bf16, bs12 @192x640, 4 loader
    workers, 36 samples: one epoch of 3 steps, ``test_iter=1``) with the
    counters set to 0 just before each step and each evaluation forward
    and read just after: every step launches what phase 33's grid-route
    bf16 step launches, each evaluation forward 14 conv3x3 and nothing
    else; the 7 metrics of both suites finite; ``scripts/test.py``'s
    ``main`` on the saved checkpoint gives the loop's evaluation (1e-6
    relative) and, on the CPU port, the continuous metrics within phase
    6's 1e-3; readings: the loop's step walls and loader waits, the
    evaluation's frames per second, the ground truth's seconds;
44. the port's JPEG reader: its C decoder (built by ``cc`` at first use)
    on files written by ``tests/disk_trees.py`` (a numpy baseline encoder
    in integer arithmetic: 900x1600 at 4:2:0, 4:2:2, 4:4:4 and grey, and
    a 451x803 4:2:0 file with restart markers): each file's sha256 and
    that of its decode equal to the digests of the file and of PIL's
    decode recorded where PIL is (the card machine has none), the decode
    bitwise equal to ``decode_plain`` on the C decoder's coefficients; a
    progressive header refused; readings: the build, one 900x1600 4:2:0
    frame's decode, a nuScenes tree's writing (24 samples of CAM_FRONT and
    CAM_BACK at 900x1600, 8 val frames with ground truth) and
    ``dataset[i]`` of it beside ``sample_ms`` of the synthetic render, in
    turns;
45. the ``nusc_wpose`` recipe from that tree: ``scripts/train.py``'s
    ``main`` on the port's ``configs/nusc_wpose_example.py`` (bf16, bs8
    @288x512, 4 loader workers, one epoch of 3 steps, ``test_iter=1``),
    the counters set to 0 just before each step and each evaluation
    forward and read just after: every step launches what phase 37's
    ``nusc_wpose`` bf16 step launches; every CAM_BACK sample's
    ``patched_mask`` reaches the step zero from the row its warp maps
    source row 700 to; each evaluation forward 14 conv3x3 and nothing
    else; the metrics of each camera and their mean finite;
    ``scripts/test.py``'s ``main`` on the saved checkpoint gives the
    loop's evaluation (1e-6 relative) and, on the CPU port, the
    continuous metrics within phase 6's 1e-3; readings as phase 43's;
46. the ``distill_nusc`` recipe from the same tree, its teacher a
    checkpoint of seeded weights written by the port's checkpoint save:
    every step launches what phase 37's ``distill_nusc`` step launches,
    the teacher bitwise unchanged after the steps, the evaluation's
    metrics finite;
47. the KITTI-360 fisheye recipe from a PNG tree written by
    ``tests/disk_trees.py`` (two Mei cameras, ``image_02`` and
    ``image_03``, 16 frames of each at 1400x1400, the cameras'
    extrinsics, poses 0.8 m apart, 30,000-point scans of the 8 val
    frames): ``dataset[i]`` beside the synthetic render, in turns; the
    ground truth of ``Kitti360FisheyeEvaluator`` (close-range pixels in
    every frame); ``scripts/train.py``'s ``main`` on the port's
    ``configs/kitti360_fisheye_example.py`` (bf16, bs16 @384x384, 4 loader
    workers, 48 samples: one epoch of 3 steps, ``test_iter=1``), the
    counters set to 0 just before each step and each evaluation forward
    and read just after: every step launches what phase 37's fisheye bf16
    step launches, by dtype and route, every batch holds both cameras, and
    kernels G and H of the first step equal their plain versions on that
    step's own operands (per-sample camera rows; phase 36's gates); each
    evaluation forward 14 conv3x3 and nothing else; ``scripts/test.py`` on
    the checkpoint gives the loop's evaluation (1e-6 relative) and, on the
    CPU port, the continuous metrics within 1e-3; readings: each step's
    wall and loader wait, the evaluation's frames per second;
48. FusionPortable: a written tree (OpenCV yaml calibration, TUM
    odometry, 7 PNG frames a camera at 768x1024, Ouster scans as ASCII and
    binary PCD); ``dataset[i]`` under an identity augmentation (both
    cameras drawn) and ``FusionPortableEvaluator``'s ground truth equal to
    SHA-256 digests recorded on the CPU, where the JAX package computed
    them; one ``KittiEvaluationHook`` pass of the flagship model over 4
    frames, each forward 14 conv3x3 and nothing else;
49. export: the flagship's ``dummy_forward`` at bs1 @192x640 float32
    exported with ``torch.export`` on the card (the decoder's 14 convs as
    the registered operator ``torch.ops.fsnet_tpu_torch.conv3x3``), saved,
    reloaded and run in a fresh Python process: within 1e-4 of the live
    model, 14 conv3x3 launches a run; the export, the reloaded and the live
    forward timed; the bs1 ``forward_test`` wall with the operator's
    dispatch and with the wrapper's launch alone, in turns;
50. the port's motion-mask tools on the card: ``bgr_to_gray`` bitwise to
    its CPU run; ``farneback`` (OpenCV's example settings) at 192x640 and
    375x1242 against the same code on the CPU within 1e-3 px; the masks
    of the two flows differing only within 1e-2 of the threshold;
    ``write_png`` read back bitwise; ms a frame pair;
51. the KITTI raw recipe on motion masks: ``scripts/train.py`` runs
    ``MotionMaskPrecomputeHook`` over a drive of 36 training samples with
    an object that moves on its own (resized to 192x640), then one epoch
    of 3 steps with ``is_motion_mask=True``: every mask marks the object,
    every step launches phase 43's kernels but the photometric forward
    once (no identity stack), every batch carries a mask; the f32 bs2 step
    with a mask on the card against the CPU port at phase 10's gate;
52. ``scripts/test.py`` on phase 45's checkpoint with
    ``PostOptFastNuscEvaluationHook`` over 8 frames a camera of the
    nuScenes tree with VO maps at 288x512 on the card, and over 2 of them
    on the card and on the CPU: 14 conv3x3 a forward and nothing else, no
    frame left unrefined, the metrics within 1e-3 relative, the first
    frame's SLIC assignment
    equal on >= 99.9% of the pixels; post-opt ms a frame, frames/s.
53. kernels E and K in bfloat16 (``csrc/warp_grid.cu``,
    ``csrc/warp_grad.cu``: 16-byte vectors of 8 channels, float32
    arithmetic; K's image cotangent summed in float32 and rounded once) at
    the 16 DCN shapes of phase 23's scene, on its inputs and offsets
    rounded to bf16 (the grid formed in bf16, widened), each launched 4
    times on the channel-wide route on bf16 operands: E bitwise equal to
    its plain version, K's gfx and gfy within 1e-5 of their largest
    entries and bitwise launch to launch, its image cotangent within one
    bf16 ulp beyond 1e-5 of its largest entry; the positional error of
    the bf16 grid against the float32 grid from the same offsets, the
    port's and the JAX package's (which unnormalises in bf16), in pixels
    (a reading); each timed beside the float32 kernel on the same values,
    the plain version and the bound at bf16 bytes;
54. one bf16 DLA step at batch 12 through ``make_train_step`` with the
    recipe's ``compute_dtype``, the counters set to 0 just before: E 16 and
    K 16, all on the channel-wide route on bf16 operands, nothing else;
    then the BN-frozen step at batch 2 on the card against the CPU port at
    phase 34's gates (loss 2e-2, gradients 0.3 and 0.6, cosine against the
    card's f32 step 0.25), its loss gate shared by the card's f32 step,
    the control, which must miss the gradients: the bf16 gradients lie
    under half the control's distance; the f32 and bf16 DLA steps timed
    as phase 35 times the flagship's;
55. the learned-pose ``MonoDepthMeta``: one step at f32 and one at bf16 at
    batch 12, the counters set to 0 just before each: conv3x3 4,
    conv3x3_bn 10, dx 14, dw 14, F 1 (row route), I 2 and J 1, the conv
    and photometric launches of the bf16 step on bf16 operands; the bf16
    step at batch 2 on the card against the CPU port at phase 38's gates;
    both steps timed as phase 39 times the recipes';
56. the residual-pose ``MonoDepthWPose`` (``entry.residual_pose_model``):
    the launches of phase 55 at f32 and bf16; the f32 step at batch 2 on
    the card against the CPU port at phase 10's gate, the bf16 one at
    phase 34's; both steps timed.

Every train step (phases 9, 13, 14, 19, 27, 29) launches the forward
kernel twice (the warped stack and the identity stack) and the cotangent
kernel once, on the vector route (the step on motion masks, phase 51,
the forward once); ``forward_test`` launches neither. The run prints its
seconds after each group of phases.

It prints the record and the kernel line as JSON lines and, last, the
result line ``{"ok": true, "device": {...}}``. It imports nothing of JAX or
of the JAX package.
"""
from __future__ import annotations

import functools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

BATCH, HEIGHT, WIDTH = 12, 192, 640
# phases 35, 39 and 54-56: windows of 20 steps timed, the fastest kept
# (bench.py times 4; 1 keeps the whole run inside its time limit)
TIMING_WINDOWS = 1
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# H100 SXM peaks (NVIDIA data sheet, 700 W): float32 outside the tensor
# cores, bf16 dense tensor cores, HBM3 bandwidth
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
# the conv kernels' own route: TF32 dense tensor cores, three products per
# float32 product (3xTF32), one per bfloat16 product
PEAK_TF32 = 495e12
TF32_PRODUCTS = {torch.float32: 3, torch.bfloat16: 1}

def decoder_shapes(H, W, bins=16, uncertain=False):
    """(name, H, W, input part channels, Co, padding) of the decoder's 14
    3x3 convs at an H x W input, in the order the main path runs them: the
    dispconvs to ``bins`` channels; with ``uncertain`` the 4 one-channel
    uncertainty convs (``uncertain_logz_{s}``) after them."""
    ch, enc = (16, 32, 64, 128, 256), (64, 64, 128, 256, 512)
    out = []
    for i in range(4, -1, -1):
        out.append((f"upconv_{i}_0", H >> (i + 1), W >> (i + 1),
                    (enc[4] if i == 4 else ch[i + 1],), ch[i], "zeros"))
        out.append((f"upconv_{i}_1", H >> i, W >> i,
                    (ch[i], enc[i - 1]) if i else (ch[i],), ch[i],
                    "replicate"))
    for s in range(4):
        out.append((f"dispconv_{s}", H >> s, W >> s, (ch[s],), bins,
                    "replicate"))
    if uncertain:
        out += [(f"uncertain_logz_{s}", H >> s, W >> s, (ch[s],), 1,
                 "replicate") for s in range(4)]
    return out


SHAPES = decoder_shapes(HEIGHT, WIDTH)
# the KITTI-360 fisheye recipe (configs/kitti360_fisheye_example.py)
FISH_BATCH, FISH_H, FISH_W, FISH_BAND = 16, 384, 384, 16
# the NuScenes recipes' batch and frame (configs/nusc_wpose_example.py,
# configs/distill_nusc_example.py): phase 12's second grid-warp scene and
# phases 27-31
NUSC_BATCH, NUSC_H, NUSC_W = 8, 288, 512
FISH_SHAPES = decoder_shapes(FISH_H, FISH_W)
# the decoder convs of the two nuScenes steps: the nusc_wpose step's 14
# (64-bin dispconvs), the distillation student's 18 (16-bin dispconvs and
# the uncertainty convs) and its teacher's 14 (forward only, in eval mode);
# NUSC_CONV_SHAPES holds each distinct shape once
NUSC_SHAPES = decoder_shapes(NUSC_H, NUSC_W, bins=64)
DISTILL_SHAPES = decoder_shapes(NUSC_H, NUSC_W, uncertain=True)
NUSC_CONV_SHAPES = [
    (n.replace("dispconv_", "dispconv64_"), *rest) for n, *rest in NUSC_SHAPES
] + [(n.replace("dispconv_", "dispconv16_"), *rest)
     for n, *rest in DISTILL_SHAPES if not n.startswith("upconv_")]


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cuda_host_ms(fn, iters: int, warmup: int = 2):
    """(mean time of ``fn`` over ``iters`` back-to-back calls by CUDA events,
    mean host time to issue one call): where the second comes near the
    first, the host, not the card, sets the pace of the back-to-back
    calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) / iters * 1e3
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, host


def bound(B, H, W, Cs, Co, dtype):
    """Least time for one conv: max(operations / peak, bytes / bandwidth),
    each input read once and the output written once."""
    ops, nbytes = conv_work(B, H, W, Cs, Co, dtype)
    t_ops, t_bytes = ops / PEAK_OPS[dtype], nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes
            else "bytes", t_ops * 1e3, t_bytes * 1e3)


def conv_work(B, H, W, Cs, Co, dtype=torch.float32):
    """(operations, bytes) of one conv pass: each input read once, the
    output written once."""
    cin = sum(Cs)
    return (2.0 * 9 * B * H * W * cin * Co,
            torch.finfo(dtype).bits // 8 * (B * H * W * cin + 9 * cin * Co
                                             + Co + B * H * W * Co))


def conv_sass(build):
    """Phase 2: the conv kernels' SASS must hold tensor-core (HMMA or HGMMA)
    and asynchronous-copy (LDGSTS or UTMALDG) instructions; counts by
    library. Fails where the toolkit has no cuobjdump beside nvcc."""
    import os

    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    check(os.path.isfile(cuobjdump), f"no cuobjdump beside nvcc "
          f"({cuobjdump}): the conv kernels' SASS cannot be checked")
    found = {}
    for name in ("conv3x3", "conv3x3_dw"):
        sass = subprocess.run([cuobjdump, "-sass",
                               str(build.library_path(name))],
                              capture_output=True, text=True, check=True,
                              timeout=120).stdout
        found[name] = {op: sass.count(op) for op in
                       ("HMMA", "HGMMA", "LDGSTS", "UTMALDG", "FFMA")}
        print(f"SASS {name}: {found[name]}")
        check(found[name]["HMMA"] + found[name]["HGMMA"] > 0,
              f"{name}: no tensor-core instruction in its SASS")
        check(found[name]["LDGSTS"] + found[name]["UTMALDG"] > 0,
              f"{name}: no asynchronous copy in its SASS")
    return found


# the warps' kernels whose global memory opcodes phase 2 counts one by one:
# the projecting warps' and the grid warps' narrow kernels, each beside its
# row-staging kernel at the recipes' channels
SASS_KERNELS = ("warp_depth_fwd_kernel", "warp_depth_fwd_vec_kernel<3>",
                "warp_mei_fwd_kernel<float,float>",
                "warp_mei_fwd_vec_kernel<float,float,3>",
                "warp_mei_fwd_kernel<bf16,float>",
                "warp_mei_fwd_vec_kernel<bf16,float,3>",
                "warp_grid_kernel<true>", "warp_grid_row_kernel<true,3>",
                "warp_grid_kernel<false>", "warp_grid_row_kernel<false,1>")


def kernel_name(mangled):
    """``warp_grid_row_kernel<true,3>`` or ``warp_mei_fwd_vec_kernel<bf16,
    float,3>`` from a mangled kernel name (template arguments of bool, int,
    float and bfloat16; a substitution ``S_``, ``S1_`` names the bfloat16
    before it, the one type of these kernels that can be substituted);
    None where it names no kernel."""
    for m in re.finditer(r"_kernel", mangled):
        end = m.end()
        # the name's length prefix ends where the name starts (the
        # anonymous namespace's own name ends in digits too)
        for n in range(len("x_kernel"), end):
            start = end - n
            if mangled[start - len(str(n)):start] == str(n) and \
                    mangled[start].isalpha():
                t = re.match(r"I((?:L[bi]\d+E|f|13__nv_bfloat16|S\d*_)+)E",
                             mangled[end:])
                args = re.findall(r"L([bi])(\d+)E|(f)|(13__nv_bfloat16|"
                                  r"S\d*_)", t.group(1) if t else "")
                return mangled[start:end] + (
                    "<" + ",".join("float" if f else "bf16" if b else
                                   ("true" if v == "1" else "false")
                                   if k == "b" else v
                                   for k, v, f, b in args) + ">"
                    if args else "")
    return None


def ptxas_lines(log):
    """ptxas's register and spill lines by kernel, from a library's
    ``-Xptxas -v`` messages."""
    name, out = None, {}
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            name = kernel_name(m.group(1)) or m.group(1)
        elif name and ("registers" in line or "spill" in line):
            out.setdefault(name, []).append(line.split(":", 1)[-1].strip())
    return out


def warp_sass(build):
    """Phase 2: the band warps' channel-wide routes, the projecting warps'
    vector routes and the grid warps' row routes in SASS. Kernel E's
    library must hold 16-byte global loads and stores (``LDG...128``,
    ``STG...128``), kernel K's vector float reductions into global memory
    (a ``RED`` of 4 floats: ``atomicAdd(float4*, float4)``), and the vector
    kernels of A and G at C = 3 and the row kernels of F at C = 3 and E at
    C = 1 128-bit global stores (``STG.E.EF.128``, streaming). Returns the
    counts of the global memory opcodes by library, and by kernel for the
    kernels of :data:`SASS_KERNELS`."""
    import os
    import re
    from collections import Counter

    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    pat = (r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?((?:LDG|STG|RED|ATOM)"
           r"[\w.]*)")
    found = {}
    for name in ("warp_grid", "warp_grad", "warp_depth", "warp_mei"):
        sass = subprocess.run([cuobjdump, "-sass",
                               str(build.library_path(name))],
                              capture_output=True, text=True, check=True,
                              timeout=120).stdout
        if name in ("warp_depth", "warp_mei", "warp_grid"):
            for part in sass.split("Function : ")[1:]:
                kname = kernel_name(part.split("\n", 1)[0])
                if kname in SASS_KERNELS:
                    found[kname] = dict(Counter(re.findall(pat, part)))
                    print(f"SASS {kname}: {found[kname]}")
            if name != "warp_grid":
                continue
        ops = Counter(re.findall(pat, sass))
        found[name] = dict(ops)
        print(f"SASS {name}: {dict(ops)}")
    wide = {n: {k: sum(c for op, c in found[n].items()
                       if op.startswith(k) and ".128" in op)
                for k in ("LDG", "STG")} for n in ("warp_grid", "warp_grad")}
    vec_red = sum(c for op, c in found["warp_grad"].items()
                  if op.startswith(("RED", "ATOM")) and
                  re.search(r"F32x4|\.128|\.V4", op))
    check(wide["warp_grid"]["LDG"] > 0 and wide["warp_grid"]["STG"] > 0,
          f"warp_grid: no 16-byte global load or store in its SASS ({wide})")
    check(wide["warp_grad"]["LDG"] > 0 and vec_red > 0,
          f"warp_grad: no 16-byte load ({wide}) or vector float reduction "
          f"({vec_red}) in its SASS")
    for k in SASS_KERNELS[1::2]:
        stg = sum(c for o, c in found.get(k, {}).items()
                  if o.startswith("STG") and ".128" in o)
        check(stg > 0, f"{k}: no 128-bit global store in its SASS "
              f"({found.get(k)})")
    return found


# the FP32 pipe's opcodes, as photo_build counts them
PHOTO_FP32 = ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "MUFU",
              "FCHK")


def _photo_name(mangled):
    """``photo_loss_fwd_vec_kernel<3>`` (the float32 kernel) or
    ``photo_loss_fwd_vec_kernel<3, bf16>`` from a mangled kernel name."""
    m = re.search(r"(photo_loss_(?:fwd|bwd)(?:_vec)?_kernel)"
                  r"(?:I(?:Li(\d)E)?(f|13__nv_bfloat16)E)?", mangled)
    if m is None:
        return mangled
    args = [a for a in (m.group(2), "bf16" if m.group(3) == "13__nv_bfloat16"
                        else None) if a]
    return m.group(1) + (f"<{', '.join(args)}>" if args else "")


def photo_build(build, log):
    """Phase 2: the photometric kernels' compile report and SASS. Prints
    ptxas's registers and spills per kernel, and per kernel of
    ``csrc/photo_loss.cu`` the counts of asynchronous copies (``LDGSTS``,
    ``UTMALDG``), 128-bit global and shared loads and stores, shuffles and
    FP32 instructions in its SASS, and the (instructions, FP32
    instructions) of each stretch of code that follows one of its barriers
    (``BAR``), up to the next barrier or exit, in program order; the vector
    route's kernels at C = 3 must hold asynchronous 16-byte copies and
    128-bit global loads and stores. Returns the SASS counts and ptxas
    lines by kernel."""
    import os
    from collections import Counter

    name, ptxas = None, {}
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            name = _photo_name(m.group(1))
        elif name and ("registers" in line or "spill" in line):
            ptxas.setdefault(name, []).append(
                line.split(':', 1)[-1].strip())
            print(f"  ptxas {name}: {ptxas[name][-1]}")
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass",
                           str(build.library_path("photo_loss"))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    found = {}
    for part in sass.split("Function : ")[1:]:
        kname = _photo_name(part.split("\n", 1)[0].strip())
        ops = re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)", part)
        base = Counter(o.split(".")[0] for o in ops)
        wide = Counter(o.split(".")[0] for o in ops if ".128" in o)
        # the code after each barrier up to the next barrier or exit, in
        # program order: its instructions and FP32 instructions
        after_bar = []
        for i, o in enumerate(ops):
            if o.startswith("BAR"):
                end = next((k for k in range(i + 1, len(ops))
                            if ops[k].startswith(("BAR", "EXIT"))), len(ops))
                after_bar.append((end - i - 1, sum(
                    1 for o in ops[i + 1:end]
                    if o.split(".")[0] in PHOTO_FP32)))
        found[kname] = dict(
            LDGSTS=base["LDGSTS"], LDGSTS_128=wide["LDGSTS"],
            UTMALDG=base["UTMALDG"], LDG_128=wide["LDG"], STG_128=wide["STG"],
            LDS_128=wide["LDS"], STS_128=wide["STS"], SHFL=base["SHFL"],
            fp32=sum(base[k] for k in PHOTO_FP32), after_bar=after_bar)
        print(f"SASS {kname}: {found[kname]}")
        found[kname]["ptxas"] = ptxas.get(kname, [])
    for k in ("photo_loss_fwd_vec_kernel<3>", "photo_loss_bwd_vec_kernel<3>"):
        f = found.get(k, {})
        check(f.get("LDGSTS_128", 0) + f.get("UTMALDG", 0) > 0
              and f.get("LDG_128", 0) > 0 and f.get("STG_128", 0) > 0,
              f"{k}: its SASS lacks 16-byte asynchronous copies or 128-bit "
              f"global loads and stores ({f})")
    return found


def tc16_bound(ops, nbytes):
    """(bound ms, what bounds it) of a pass on bfloat16 operands at the bf16
    dense tensor-core rate (989 TFLOP/s) against its bytes at the HBM
    rate."""
    return ms_bound(ops, nbytes, torch.bfloat16)


def tc_bound(ops, nbytes, dtype=torch.float32):
    """(bound ms, what bounds it) of a conv pass on the conv kernels' route:
    its TF32 tensor-core products at 495 TFLOP/s (three per float32
    product) against its bytes at the HBM rate."""
    t_ops = TF32_PRODUCTS[dtype] * ops / PEAK_TF32
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def conv_inputs(B, H, W, Cs, Co, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    parts = [torch.randn(B, H, W, c, generator=g, device="cuda").to(dtype)
             for c in Cs]
    w = (torch.randn(3, 3, sum(Cs), Co, generator=g, device="cuda")
         / np.sqrt(9 * sum(Cs))).to(dtype)
    b = (0.1 * torch.randn(Co, generator=g, device="cuda")).to(dtype)
    return parts, w, b


def flagship_batch(batch: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    P2 = np.zeros((batch, 3, 4), np.float32)
    P2[:, 0, 0] = P2[:, 1, 1] = 0.58 * WIDTH
    P2[:, 0, 2], P2[:, 1, 2], P2[:, 2, 2] = WIDTH / 2, HEIGHT / 2, 1.0
    img = rng.rand(batch, HEIGHT, WIDTH, 3).astype(np.float32)
    return {"image/0": img, "P2": P2}


def launch_counters():
    """The launch counter of every kernel wrapper, by kernel name."""
    from fsnet_tpu_torch.ops import conv3x3 as tc
    from fsnet_tpu_torch.ops import photo_loss as tpl
    from fsnet_tpu_torch.ops import warp_depth as twd
    from fsnet_tpu_torch.ops import warp_fast as twf
    from fsnet_tpu_torch.ops import warp_mei as twm

    return {"conv3x3": tc.conv3x3, "conv3x3_bn": tc.conv3x3_bn,
            "conv3x3_dx": tc.conv3x3_dx, "conv3x3_dw": tc.conv3x3_dw,
            "warp_depth_fwd": twd.warp_depth_fwd,
            "warp_depth_bwd": twd.warp_depth_bwd,
            "warp_grid_fused": twf.grid_band_fused,
            "warp_grid_fwd": twf.grid_band_fwd,
            "warp_grid_bwd": twf.grid_band_bwd,
            "warp_mei_fwd": twm.warp_mei_fwd,
            "warp_mei_bwd": twm.warp_mei_bwd,
            "photo_loss_fwd": tpl.photo_loss_fwd,
            "photo_loss_bwd": tpl.photo_loss_bwd}


def zero(counters) -> None:
    for fn in counters.values():
        fn.launches = 0
        if hasattr(fn, "routes"):
            fn.routes = dict.fromkeys(fn.routes, 0)
        if hasattr(fn, "dtypes"):
            fn.dtypes = dict.fromkeys(fn.dtypes, 0)


def routes(counters):
    """Launches by route of the kernels that have two (E and K)."""
    return {k: dict(fn.routes) for k, fn in counters.items()
            if hasattr(fn, "routes")}


def read(counters):
    return {k: fn.launches for k, fn in counters.items()}


def taken(counts) -> str:
    """The routes that launched, from a kernel's launches by route."""
    return "+".join(k for k, n in counts.items() if n) or "none"


def rel_err(got, ref, scale=None):
    """(max |got - ref|, that over ``scale`` or max |ref|)."""
    diff = (got.double() - ref.double()).abs().max().item()
    den = ref.double().abs().max().item() if scale is None else scale
    return diff, diff / max(den, 1e-30)


def ms_bound(ops, nbytes, dtype=torch.float32):
    """(bound ms, what bounds it): operations at ``dtype``'s peak (float32:
    outside the tensor cores), bytes at the HBM rate."""
    t_ops, t_bytes = ops / PEAK_OPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def sum_bounds(items):
    """Sum of per-shape (ops, bytes) -> (bound ms, what bounds the sum)."""
    return ms_bound(sum(o for o, _ in items), sum(b for _, b in items))


# (S scales, F frames) of the flagship's warp
S_SCALES, F_FRAMES, BAND = 4, 2, 4


def lane_window_moves(x, W, L=128, window=3, nearest=False):
    """Samples whose corner columns the TPU kernels' lane window
    (``prep_kernel.py:150-164``, ``warp_kernel.py:236-309``) would have
    clamped: per output row and 128-lane output tile the columns are held
    to ``window`` tiles ending at the tile of the row's largest right
    corner. ``x`` [N, H, W] unclamped; bilinear corners of the border
    clamp, or with ``nearest`` those of the unclamped nearest warp."""
    T = W // L
    if T * L != W:
        return None
    kw = min(window, T)
    x0f = torch.floor(x + 0.5) if nearest else torch.floor(x.clamp(0.0, W - 1))
    x0 = x0f.clamp(0, W - 1).long()
    x1 = (x0f + 1).clamp(0, W - 1).long()
    hi = x1.view(*x1.shape[:2], T, L).amax(dim=-1) // L          # [N, H, T]
    lo = ((hi - (kw - 1)).clamp(0, T - kw) * L).repeat_interleave(L, dim=-1)
    hic = lo + kw * L - 1
    moved = (x0 < lo) | (x0 > hic) | (x1 < lo) | (x1 > hic)
    return int(moved.sum().item())


def warp_scene(batch_np, seed=0):
    """The warp's operands at the flagship batch: sources, per-scale depth
    and the projection rows of the batch's GT poses."""
    from fsnet_tpu_torch.ops.geometry import invert_K, make_K44
    from fsnet_tpu_torch.ops.warp_depth import make_affine_rows

    dev = "cuda"
    B = batch_np["P2"].shape[0]
    g = torch.Generator(device=dev).manual_seed(seed)
    image = torch.cat([torch.from_numpy(batch_np[f"original_image/{f}"])
                       for f in (1, -1)]).to(dev).contiguous()
    depth = (2.0 + 40.0 * torch.rand(S_SCALES * B, HEIGHT, WIDTH,
                                     generator=g, device=dev))
    K = make_K44(torch.from_numpy(batch_np["P2"]).to(dev))
    Ts = torch.stack([torch.from_numpy(batch_np[f"relative_pose/{f}"])
                      for f in (1, -1)]).to(dev)
    return image, depth, make_affine_rows(K, invert_K(K), Ts, S_SCALES)


# phases 8 and 17 launch each conv kernel this many times per shape
# (``--conv-repeats``): the outputs no atomic add touches (forward, the
# moments kernel's stored output, dx) must equal the first launch's bit for
# bit, and every launch must meet its gate
REPEATS = 4
# where a conv kernel's miss leaves its inputs and worst elements (git-ignored)
FAULT_DIR = Path(__file__).resolve().parent / "build" / "conv_faults"


def save_fault(tag, what, inputs, got, first, ref, ref64, gate_abs):
    """Writes a conv kernel's miss to ``FAULT_DIR/<tag>.pt``: the inputs
    (when they take under 64 MB), and the 4096 worst elements of ``got``
    with their indices beside the first launch's (``first``, or None), the
    float32 plain version and a float64 reference; prints where the worst element lies and which of the two
    float32 results the float64 one sides with."""
    d = (got.double() - ref.double()).abs().flatten()
    worst = d.topk(min(4096, d.numel())).indices
    r64 = ref64.flatten()[worst]
    e_got = (got.double().flatten()[worst] - r64).abs().max().item()
    e_ref = (ref.double().flatten()[worst] - r64).abs().max().item()
    at = np.unravel_index(int(worst[0]), tuple(got.shape))
    nbad = int((d > gate_abs).sum().item())
    print(f"FAULT {tag}: {what}; {nbad} elements over the gate, the worst at "
          f"{tuple(int(i) for i in at)} of {tuple(got.shape)}; against "
          f"float64 there: kernel {e_got:.3e}, plain {e_ref:.3e}")
    rec = dict(what=what, shape=tuple(got.shape), nbad=nbad,
               index=worst.cpu(), got=got.flatten()[worst].cpu(),
               ref=ref.flatten()[worst].cpu(), ref64=r64.cpu())
    if first is not None:
        rec["first"] = first.flatten()[worst].cpu()
    if sum(t.numel() * t.element_size() for t in inputs.values()) < 64e6:
        rec["inputs"] = {k: v.cpu() for k, v in inputs.items()}
    FAULT_DIR.mkdir(parents=True, exist_ok=True)
    torch.save(rec, FAULT_DIR / f"{tag}.pt")


class Held:
    """One output of a conv kernel held over repeated launches: each launch
    against the plain ``ref`` (max |got - ref| over ``scale``, default max
    |ref|, within ``gate``) and, with ``exact``, bitwise against the first
    launch. A miss is saved (:func:`save_fault`; ``ref64()`` gives the
    float64 reference) before the run fails."""

    def __init__(self, tag, ref, gate, exact, inputs, ref64, scale=None):
        self.tag, self.ref, self.gate, self.exact = tag, ref, gate, exact
        self.inputs, self.ref64 = inputs, ref64
        self.den = ref.double().abs().max().item() if scale is None else scale
        self.first, self.n, self.d, self.e = None, 0, 0.0, 0.0

    def __call__(self, got):
        self.n += 1
        d, e = rel_err(got, self.ref, self.den)
        self.d, self.e = max(self.d, d), max(self.e, e)
        if self.exact and self.first is None:
            self.first = got
        same = not self.exact or torch.equal(got, self.first)
        if e > self.gate or not same:
            what = (f"launch {self.n}: rel err {e:.2e} (gate {self.gate:.0e})"
                    + ("" if same else ", not bitwise equal to launch 1"))
            save_fault(f"{self.tag}_launch{self.n}", what, self.inputs, got,
                       self.first, self.ref, self.ref64(),
                       self.gate * self.den)
            check(False, f"{self.tag}: {what}")


def check_conv_kernels(B, shapes, rows, tag, forward=False):
    """The conv kernels against their plain versions at ``shapes`` and
    batch ``B``, float32, each launched :data:`REPEATS` times (see there):
    with ``forward`` the conv (rel <= 1e-4, as phase 4), the moments
    epilogue at the upconvs, the input and the weight cotangent at all (rel
    <= 2e-5). Returns the max abs errors by kernel."""
    from fsnet_tpu_torch.ops import conv3x3 as tc

    errs = {k: 0.0 for k in ("conv3x3", "conv3x3_bn", "conv3x3_bn_mom",
                             "conv3x3_dx", "conv3x3_dw")}
    for i, (name, H, W, Cs, Co, pad) in enumerate(shapes):
        parts, w, b = conv_inputs(B, H, W, Cs, Co, torch.float32, seed=i)
        gy = torch.randn(B, H, W, Co, device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(100 + i))
        inputs = {f"x{j}": p for j, p in enumerate(parts)}
        inputs.update(w=w, b=b, gy=gy)
        at = f"{tag}_{name}"

        def conv64():
            return tc._conv_core([p.double() for p in parts], w.double(),
                                 b.double(), pad)

        ref = tc.conv3x3_plain(parts, w, b, pad)
        bn = name.startswith("upconv_")
        held = {}
        if forward:
            held["conv"] = Held(f"{at}_conv", ref, TOL[torch.float32], True,
                                inputs, conv64)
        if bn:
            r1, r2 = tc.moments_plain(ref)
            held["bn"] = Held(f"{at}_bn_out", ref, 2e-5, True, inputs, conv64)
            # s1 sums values of both signs: its scale is the sum of |out|
            held["s1"] = Held(f"{at}_bn_s1", r1, 2e-5, False, inputs,
                              lambda: tc.moments_plain(conv64())[0],
                              ref.abs().sum((0, 1, 2)).max().item())
            held["s2"] = Held(f"{at}_bn_s2", r2, 2e-5, False, inputs,
                              lambda: tc.moments_plain(conv64())[1])
        for j, r in enumerate(tc.conv3x3_dx_plain(gy, w, pad, Cs)):
            held[f"dx{j}"] = Held(
                f"{at}_dx{j}", r, 2e-5, True, inputs,
                lambda j=j: tc.conv3x3_dx_plain(gy.double(), w.double(), pad,
                                                Cs)[j])
        held["dw"] = Held(f"{at}_dw", tc.conv3x3_dw_plain(parts, gy, pad),
                          2e-5, False, inputs,
                          lambda: tc.conv3x3_dw_plain(
                              [p.double() for p in parts], gy.double(), pad))
        del ref
        for _ in range(REPEATS):
            got = {}
            if forward:
                got["conv"] = tc.conv3x3(parts, w, b, pad)
            if bn:
                got["bn"], got["s1"], got["s2"] = tc.conv3x3_bn(parts, w, b,
                                                                pad)
            for j, dx in enumerate(tc.conv3x3_dx(gy, w, pad, Cs)):
                got[f"dx{j}"] = dx
            got["dw"] = tc.conv3x3_dw(parts, gy, pad)
            torch.cuda.synchronize()
            for k, v in got.items():
                held[k](v)
        dx = [h for k, h in held.items() if k.startswith("dx")]
        e_dx = max(h.e for h in dx)
        errs["conv3x3_dx"] = max([errs["conv3x3_dx"]] + [h.d for h in dx])
        errs["conv3x3_dw"] = max(errs["conv3x3_dw"], held["dw"].d)
        row = rows[i]
        row.update(dx_rel_err=e_dx, dw_rel_err=held["dw"].e)
        line = ""
        if forward:
            row["rel_err"] = held["conv"].e
            errs["conv3x3"] = max(errs["conv3x3"], held["conv"].d)
            line += f"conv {row['rel_err']:.2e} "
        if bn:
            row.update(bn_rel_err=held["bn"].e, s1_rel_err=held["s1"].e,
                       s2_rel_err=held["s2"].e)
            errs["conv3x3_bn"] = max(errs["conv3x3_bn"], held["bn"].d)
            errs["conv3x3_bn_mom"] = max(errs["conv3x3_bn_mom"],
                                         held["s1"].d, held["s2"].d)
            line += (f"bn out {row['bn_rel_err']:.2e} s1 "
                     f"{row['s1_rel_err']:.2e} s2 {row['s2_rel_err']:.2e} ")
        print(f"check {name:11s} B{B} {H}x{W} conv kernels x{REPEATS}: rel err "
              f"{line}dx {e_dx:.2e} dw {row['dw_rel_err']:.2e}")
    return errs


# the routes of the projecting warps, kernels A and G; phases 8 and 17
# launch each this many times at the recipe's shapes, in turns
PROJ_ROUTES = ("vector", "narrow")
PROJ_REPEATS = 4


# the routes of the grid warps F and E (the mask) on the grid route; phase
# 12 launches each PROJ_REPEATS times at both scenes, in turns
GRID_ROUTES = ("row", "narrow")


def check_routes(what, launch, ref, routes=PROJ_ROUTES,
                 outputs="out, overlap, va, vb"):
    """Phases 8, 12 and 17: ``launch(route)`` (kernel A, G, F or E) on each
    of ``routes`` ``PROJ_REPEATS`` times in turns (the main path's route,
    the narrow one, the narrow one, the main path's, ...); every launch's
    ``outputs`` must equal the plain version's ``ref`` bit for bit, and so
    route to route and launch to launch."""
    bad = dict.fromkeys(routes, 0)
    for k in range(PROJ_REPEATS):
        for r in routes if k % 2 == 0 else routes[::-1]:
            got = launch(r)
            torch.cuda.synchronize()
            bad[r] += not all(torch.equal(a, b) for a, b in zip(got, ref))
            del got
    print(f"check {what}: {PROJ_REPEATS} launches on each route "
          f"{routes}, launches not bitwise equal to the plain version "
          f"({outputs}): {bad}")
    check(not any(bad.values()), f"{what}: launches not bitwise equal to the "
          f"plain version by route: {bad}")


def time_routes(entry, launch, routes_taken, routes=PROJ_ROUTES):
    """Phases 11, 16 and 21: kernel A, G, F or E timed on each of
    ``routes`` in turns (the main path's route, the narrow one, the narrow
    one, the main path's; CUDA events over 10 back-to-back launches each),
    into its kernel line ``entry``: ``ms`` the main path's route's least
    reading, the narrow route's under ``routes``; ``routes_taken`` the main
    path's launches by route."""
    main, other = routes
    ms = {r: [] for r in routes}
    for r in routes + routes[::-1]:
        ms[r].append(cuda_ms(launch[r], iters=10))
    entry.update(warp_route=taken(routes_taken), ms=min(ms[main]),
                 ms_readings=ms[main],
                 routes={other: dict(launches=routes_taken[other],
                                     ms=min(ms[other]),
                                     ms_readings=ms[other])})
    entry["note"] += (f"; ms: the {main} route (the main path's), the least "
                      f"of two readings taken in turns with the {other} "
                      f"route (routes.{other})")


def route_line(e):
    """The routes' readings of a kernel line entry, for the printed line."""
    if "ms_readings" not in e or "warp_route" not in e:
        return ""
    n = e["routes"]["narrow"]
    return (f" {e['warp_route']} {e['ms_readings']} (narrow {n['ms']:.4f} "
            f"{n['ms_readings']})")


def check_training_kernels(batch_np, rows):
    """Phase 8: each training kernel against its plain version, on the
    card, at the train path's shapes. Returns per-kernel errors and the
    inputs the timings reuse."""
    from fsnet_tpu_torch.ops import warp_depth as twd
    from fsnet_tpu_torch.ops.geometry import project_rows

    errs = check_conv_kernels(BATCH, SHAPES, rows, tag="flagship")
    image, depth, arows = warp_scene(batch_np)
    route = twd.proj_route(image, depth, arows)
    check(route == "vector", f"kernel A at the recipe: route {route}")
    got = twd.warp_depth_fwd(image, depth, arows, S_SCALES, F_FRAMES, BAND)
    gy = torch.randn(got[0].shape, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(7))
    dd = twd.warp_depth_bwd(depth, gy, got[2], got[3], arows, S_SCALES,
                            F_FRAMES)
    torch.cuda.synchronize()
    ref = twd.warp_depth_plain(image, depth, arows, S_SCALES, F_FRAMES, BAND)
    dd_ref = twd.warp_depth_bwd_plain(depth, gy, ref[2], ref[3], arows,
                                      S_SCALES, F_FRAMES)
    ov_diff = int((got[1] != ref[1]).sum().item())
    fwd = max(rel_err(a, r)[0] for a, r in zip((got[0], got[2], got[3]),
                                              (ref[0], ref[2], ref[3])))
    d_dd, e_dd = rel_err(dd, dd_ref)
    errs["warp_depth_fwd"], errs["warp_depth_bwd"] = fwd, d_dd
    x = project_rows(twd._per_warp_depth(depth, S_SCALES, F_FRAMES),
                     arows)["x"]
    moved = lane_window_moves(x, WIDTH)
    print(f"check warp N={arows.shape[0]} {HEIGHT}x{WIDTH} band {BAND}: "
          f"fwd ({route} route) max abs err {fwd:.2e} (out, va, vb), overlap "
          f"mismatches {ov_diff}, d depth rel err {e_dd:.2e}; TPU "
          f"lane-window clamp would move {moved} of {x.numel()} samples")
    check(ov_diff == 0 and fwd == 0, "warp forward kernel disagrees")
    check(e_dd <= 1e-6, f"warp backward kernel: rel err {e_dd:.2e} > 1e-6")
    check_routes(
        f"kernel A N={arows.shape[0]} {HEIGHT}x{WIDTH}",
        lambda r: twd._launch_fwd(r, image, depth, arows, S_SCALES, F_FRAMES,
                                  BAND), ref)
    return errs, dict(image=image, depth=depth, arows=arows, gy=gy,
                      va=got[2], vb=got[3], lane_window_moves=moved,
                      samples=x.numel())


def white_noise_images(batch_np, seed=7):
    """The batch with its images replaced by white noise in [0, 1): the
    synthetic textures are so smooth that many 3x3 SSIM windows have a
    variance at float32 rounding level, where the variance clamp switches
    their gradient on and off at random."""
    rng = np.random.RandomState(seed)
    out = dict(batch_np)
    for key in sorted(out):
        if key.startswith(("image/", "original_image/")):
            out[key] = rng.rand(*out[key].shape).astype(np.float32)
    return out


def bn_cancelled(name):
    """Conv biases right before train-mode BN (the decoder's ConvBnReLU
    blocks, the DLA head's deformable convs): BN removes them, so their
    exact gradient is 0 and both sides hold rounding noise."""
    return name.endswith(".conv.bias") and any(
        k in name for k in (".upconv_", ".proj_", ".node_"))


def grad_rel_l2(g_a, g_b):
    """Global rel-L2 of the gradients ``g_a`` against ``g_b`` (by parameter
    name), without the BN-cancelled biases."""
    kept = [k for k in g_b if not bn_cancelled(k)]
    num = sum(float(((g_a[k].double() - g_b[k].double()) ** 2).sum())
              for k in kept)
    den = sum(float((g_b[k].double() ** 2).sum()) for k in kept)
    return (num / den) ** 0.5


def one_step(build, batch, dev, H, W, dtype=torch.float32, optimizer=None,
             compute_dtype=None, reprojection=False):
    """(loss, gradients, first Adam updates) of one train step of
    ``build(H, W, ...)`` from its seeded weights, on ``dev`` in ``dtype``
    (float64 only on the CPU, through the plain versions), with
    ``optimizer(model)`` (default the flagship's), through
    ``make_train_step(compute_dtype=compute_dtype)``; with
    ``reprojection`` the loss less its distillation terms (weighted as the
    head weighs them)."""
    from fsnet_tpu_torch.entry import flagship_optimizer
    from fsnet_tpu_torch.ops import warp_fast as twf
    from fsnet_tpu_torch.runtime.state import make_train_step

    m = build(H, W, device=dev, seed=0).to(dtype)
    o, _ = (optimizer or flagship_optimizer)(m)
    start = {k: p.detach().cpu().double().clone()
             for k, p in m.named_parameters()}
    if dtype == torch.float64:
        batch = {k: v.astype(np.float64) for k, v in batch.items()}
    dtypes, twf._DTYPES = twf._DTYPES, (dtype,)
    try:
        met = make_train_step(dev, compute_dtype=compute_dtype,
                              with_grads=True)(m, o, batch)
    finally:
        twf._DTYPES = dtypes
    loss = float(met["loss"])
    if reprojection:
        loss -= m.head.distillation_loss_weight * sum(
            float(v) for k, v in met.items() if k.startswith("distilation/"))
    return (loss,
            {k: g.detach().cpu().double() for k, g in met["_grads"].items()},
            {k: p.detach().cpu().double() - start[k]
             for k, p in m.named_parameters()})


def card_vs_cpu(build, batch, what, H=HEIGHT, W=WIDTH, optimizer=None):
    """One train step of ``build(H, W, ...)`` on the card and through the
    port on the CPU, from the same seeded weights and ``batch``, held to the
    JAX package's own backward gate between two routes: loss rel <= 1e-4,
    global gradient rel-L2 < 3e-2, every leaf < 0.5, Adam's first update
    off by more than lr / 2 on under 2% of the parameters."""
    (l_card, g_card, u_card) = one_step(build, batch, "cuda", H, W,
                                        optimizer=optimizer)
    (l_cpu, g_cpu, u_cpu) = one_step(build, batch, "cpu", H, W,
                                     optimizer=optimizer)
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    grad_rel = grad_rel_l2(g_card, g_cpu)
    zero = [k for k in g_cpu if not bool(g_cpu[k].any())]
    check(all(not bool(g_card[k].any()) for k in zero),
          f"{what}: gradients zero on the CPU but not on the card: {zero}")
    leaf = {k: float((g_card[k] - g_cpu[k]).norm() / g_cpu[k].norm())
            for k in g_cpu if not bn_cancelled(k) and k not in zero}
    worst = max(leaf, key=leaf.get)
    lr = 1e-4
    n_upd = sum(u.numel() for u in u_cpu.values())
    upd_frac = sum(int(((u_card[k] - u_cpu[k]).abs() > lr / 2).sum())
                   for k in u_cpu) / n_upd
    bs = next(iter(batch.values())).shape[0]
    print(f"card vs CPU port, {what} bs{bs}@{H}x{W}: loss "
          f"{l_card:.6f} vs {l_cpu:.6f} (rel {loss_rel:.2e}), global grad "
          f"rel-L2 {grad_rel:.2e}, worst leaf {worst} {leaf[worst]:.2e}, "
          f"Adam updates differing by > lr/2: {upd_frac:.4%}")
    check(loss_rel <= 1e-4, f"{what}: card vs CPU loss rel {loss_rel:.2e} "
          "> 1e-4")
    check(grad_rel < 3e-2, f"{what}: card vs CPU grad rel-L2 "
          f"{grad_rel:.2e} >= 3e-2")
    check(leaf[worst] < 0.5, f"{what}: card vs CPU grad of {worst}: rel-L2 "
          f"{leaf[worst]:.2e} >= 0.5")
    check(upd_frac < 0.02, f"{what}: card vs CPU Adam updates differ on "
          f"{upd_frac:.2%} of the parameters")
    return dict(loss_rel=loss_rel, grad_rel_l2=grad_rel, worst_leaf=worst,
                worst_leaf_rel_l2=leaf[worst], adam_update_differs=upd_frac,
                zero_gradient_leaves=zero)


def drive_steps(model, opt, batch, counters, want, what, steps=3,
                size=f"bs{BATCH}@{HEIGHT}x{WIDTH}", frozen=None):
    """Phases 9, 13, 14, 19, 25, 27, 29: ``steps`` train steps through
    ``make_train_step``, the launch counters set to 0 just before and read
    just after; checks the launches per step against ``want``, finite
    losses and loss terms, and that the parameters and BN running variances
    changed; those under the prefix ``frozen`` (the distillation teacher)
    must keep every parameter and statistic bit for bit instead."""
    from fsnet_tpu_torch.runtime.state import make_train_step

    step = make_train_step("cuda")
    kept = {n: t.clone() for n, t in model.state_dict().items()
            if frozen and n.startswith(frozen)}
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()
          if n not in kept}
    s0 = {n: b.clone() for n, b in model.named_buffers()
          if n.endswith("running_var") and n not in kept}
    zero(counters)
    losses = []
    for _ in range(steps):
        met = step(model, opt, batch)
        losses.append(float(met["loss"]))
    torch.cuda.synchronize()
    counts = read(counters)
    terms = {k: float(v) for k, v in met.items()}
    print(f"{what}: {steps} steps {size} f32, "
          f"losses {losses}, launches {counts}")
    check(all(np.isfinite(losses)) and all(np.isfinite(list(terms.values()))),
          f"{what}: non-finite loss {losses} or loss terms {terms}")
    state = model.state_dict()
    moved = [n for n, t in kept.items() if not torch.equal(state[n], t)]
    check(not moved, f"{what}: {len(moved)} of the {len(kept)} frozen "
          f"tensors under {frozen} changed: {moved[:5]}")
    check(counts == {k: n * steps for k, n in want.items()},
          f"{what} launches {counts}, expected per step {want}")
    changed = {n for n, p in model.named_parameters()
               if n in p0 and bool((p.detach() != p0[n]).any())}
    stats_moved = sum(int((b != s0[n]).any().item())
                      for n, b in model.named_buffers() if n in s0)
    check(len(changed) >= len(p0) - 10 and stats_moved == len(s0),
          f"{what}: {len(changed)} of {len(p0)} parameters and {stats_moved} "
          f"of {len(s0)} BN variances changed")
    return dict(steps=steps, losses=losses, launches=counts,
                routes=routes(counters), last_terms=terms,
                launches_per_step=want, params_changed=len(changed),
                params=len(p0), unchanged=sorted(set(p0) - changed),
                frozen_bitwise=len(kept))


def time_conv_kernels(B, shapes, rows, forward=False, dtype=torch.float32):
    """Phases 11, 31 and 35: each conv kernel at ``shapes`` and batch ``B``
    on ``dtype`` operands (CUDA events over 10 back-to-back launches), with
    its plain version, its two bounds (float32 CUDA cores, TF32 tensor
    cores: three products a float32 one, one a bfloat16 one; in bfloat16
    also the bf16 tensor cores' ``tc16_bound_ms``) and, at a one-part
    zero-padded shape, the one PyTorch call of the same function (cuDNN in
    ``dtype``; a yardstick only): the moments kernel at the upconvs, the
    input and weight cotangents at all and, with ``forward``, the forward
    at all. Fills each shape's row of ``rows``; returns the sums by
    kernel."""
    import torch.nn.functional as F

    from fsnet_tpu_torch.ops import conv3x3 as tc

    torch.backends.cudnn.benchmark = True      # the yardstick's best
    names = (("conv3x3",) if forward else ()) + ("conv3x3_bn", "conv3x3_dx",
                                                  "conv3x3_dw")
    tot = {k: dict(ms=0.0, plain_ms=0.0, items=[], lib_ms=0.0,
                   lib_kernel_ms=0.0, lib_shapes=[]) for k in names}
    sz = torch.finfo(dtype).bits // 8          # bytes of an operand
    for i, (name, H, W, Cs, Co, pad) in enumerate(shapes):
        parts, w, b = conv_inputs(B, H, W, Cs, Co, dtype, seed=i)
        gy = torch.randn(B, H, W, Co, device="cuda").to(dtype)
        n, cin = B * H * W, sum(Cs)
        row = rows[i]
        timed = {}
        lib = len(Cs) == 1 and pad == "zeros"
        xc = parts[0].permute(0, 3, 1, 2)
        wc = w.permute(3, 2, 0, 1).contiguous()
        gc = gy.permute(0, 3, 1, 2)
        if forward:
            timed["conv3x3"] = (
                lambda: tc.conv3x3(parts, w, b, pad),
                lambda: tc.conv3x3_plain(parts, w, b, pad),
                conv_work(B, H, W, Cs, Co, dtype),
                (lambda: F.conv2d(xc, wc, b, padding=1)) if lib else None)
        if name.startswith("upconv_"):
            timed["conv3x3_bn"] = (
                lambda: tc.conv3x3_bn(parts, w, b, pad),
                lambda: tc.moments_plain(tc.conv3x3_plain(parts, w, b, pad)),
                (2.0 * 9 * n * cin * Co + 3.0 * n * Co,
                 sz * (n * cin + 9 * cin * Co + Co + n * Co) + 8.0 * Co),
                None)
        timed["conv3x3_dx"] = (
            lambda: tc.conv3x3_dx(gy, w, pad, Cs),
            lambda: tc.conv3x3_dx_plain(gy, w, pad, Cs),
            (2.0 * 9 * n * Co * cin,
             sz * (n * Co + 9 * cin * Co + n * cin)),
            (lambda: torch.nn.grad.conv2d_input(xc.shape, wc, gc, padding=1))
            if lib else None)
        timed["conv3x3_dw"] = (         # the weight cotangent is float32
            lambda: tc.conv3x3_dw(parts, gy, pad),
            lambda: tc.conv3x3_dw_plain(parts, gy, pad),
            (2.0 * 9 * n * cin * Co,
             sz * (n * cin + n * Co) + 4.0 * 9 * cin * Co),
            (lambda: torch.nn.grad.conv2d_weight(xc, wc.shape, gc, padding=1))
            if lib else None)
        for k, (fn, plain, ob, library) in timed.items():
            t = tot[k]
            ms = cuda_ms(fn, iters=10)
            t["ms"] += ms
            plain0 = t["plain_ms"]
            t["plain_ms"] += cuda_ms(plain, iters=3, warmup=1)
            t["items"].append(ob)
            row[f"{k}_ms"] = ms
            row[f"{k}_plain_ms"] = t["plain_ms"] - plain0
            row[f"{k}_work"] = ob
            row[f"{k}_bound_ms"] = ms_bound(*ob)[0]
            row[f"{k}_tc_bound_ms"] = tc_bound(*ob, dtype)[0]
            if dtype == torch.bfloat16:
                row[f"{k}_tc16_bound_ms"] = tc16_bound(*ob)[0]
            if library is not None:
                row[f"{k}_library_ms"] = cuda_ms(library, iters=10)
                t["lib_ms"] += row[f"{k}_library_ms"]
                t["lib_kernel_ms"] += ms
                t["lib_shapes"].append(name)
        print(f"time  {name:11s} {str(dtype)[6:]} "
              + "  ".join(f"{k[8:]} {row[f'{k}_ms']:.4f} ms (bound f32 "
                          f"{row[f'{k}_bound_ms']:.4f}, TF32 "
                          f"{row[f'{k}_tc_bound_ms']:.4f}"
                          + (f", bf16 TC {row[f'{k}_tc16_bound_ms']:.4f}"
                             if f"{k}_tc16_bound_ms" in row else "")
                          + (f"; cuDNN {row[f'{k}_library_ms']:.4f}"
                             if f"{k}_library_ms" in row else "") + ")"
                          for k in timed))
    torch.backends.cudnn.benchmark = False
    return tot


def train_phases(counters, record):
    """Phases 8-11. Returns the launch counts of the train path and the
    kernel line's entries of the training kernels."""
    from fsnet_tpu_torch.entry import flagship_model, flagship_optimizer
    from fsnet_tpu_torch.ops import warp_depth as twd
    from fsnet_tpu_torch.runtime.state import make_train_step

    rows = [dict(name=n) for n, *_ in SHAPES]
    batch = {k: v for k, v in flagship_masked_np().items()
             if k != "patched_mask"}

    # 8. training kernels against their plain versions
    errs, warp_in = check_training_kernels(batch, rows)
    record["lane_window_moves"] = dict(moved=warp_in["lane_window_moves"],
                                       samples=warp_in["samples"])

    # 9. the train path, three steps at bs12
    model = flagship_model(HEIGHT, WIDTH, device="cuda", seed=0)
    opt, _ = flagship_optimizer(model)
    step = make_train_step("cuda")
    want = dict(conv3x3=4, conv3x3_bn=10, conv3x3_dx=len(SHAPES),
                conv3x3_dw=len(SHAPES), warp_depth_fwd=1, warp_depth_bwd=1,
                warp_grid_fused=0, warp_grid_fwd=0, warp_grid_bwd=0,
                warp_mei_fwd=0,
                warp_mei_bwd=0, photo_loss_fwd=2, photo_loss_bwd=1)
    record["train_path"] = drive_steps(model, opt, batch, counters, want,
                                       "train path")
    counts = record["train_path"]["launches"]
    got = record["train_path"]["routes"]["warp_depth_fwd"]
    check(got == dict(narrow=0, vector=3),
          f"train path: kernel A routes {got}, expected its 3 launches on "
          "the vector route")

    # 10. one step at bs2 on the card against the port on the CPU
    small = white_noise_images({k: v[:2] for k, v in batch.items()})
    record["train_card_vs_cpu"] = card_vs_cpu(flagship_model, small,
                                              "train step")

    # 11. timings: the train step with the batch on the card (as bench.py
    # times the JAX step) and from host numpy arrays (pageable copies
    # included), then each training kernel
    on_card = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    n_steps = 10

    def step_ms(b):
        for _ in range(2):
            step(model, opt, b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step(model, opt, b)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n_steps * 1e3

    torch.cuda.reset_peak_memory_stats()
    ms_card = step_ms(on_card)
    peak = torch.cuda.max_memory_allocated() / 1e9
    ms_host = step_ms(batch)
    record["train_step"] = dict(bs=BATCH, ms=ms_card,
                                imgs_per_s=BATCH / ms_card * 1e3,
                                ms_from_host=ms_host, peak_mem_gb=peak)
    print(f"train step bs{BATCH}@{HEIGHT}x{WIDTH} f32 (mean of {n_steps}): "
          f"batch on the card {ms_card:.3f} ms = "
          f"{BATCH / ms_card * 1e3:.2f} imgs/s (peak memory {peak:.3f} GB); "
          f"from host numpy {ms_host:.3f} ms = "
          f"{BATCH / ms_host * 1e3:.2f} imgs/s")

    tot = time_conv_kernels(BATCH, SHAPES, rows)
    record["train_shapes"] = rows

    # the warp at N = 96
    img, dep, ar = warp_in["image"], warp_in["depth"], warp_in["arows"]
    N, C = ar.shape[0], img.shape[-1]
    FB, SB, px = img.shape[0], dep.shape[0], N * HEIGHT * WIDTH
    warp_t = {
        "warp_depth_fwd": (
            {r: (lambda r=r: twd._launch_fwd(r, img, dep, ar, S_SCALES,
                                             F_FRAMES, BAND))
             for r in PROJ_ROUTES},
            lambda: twd.warp_depth_plain(img, dep, ar, S_SCALES, F_FRAMES,
                                         BAND),
            (px * (32.0 + 14.0 * C),
             4.0 * (FB * HEIGHT * WIDTH * C + SB * HEIGHT * WIDTH + N * 16)
             + px * (3 * 4.0 * C + 1))),
        "warp_depth_bwd": (
            lambda: twd.warp_depth_bwd(dep, warp_in["gy"], warp_in["va"],
                                       warp_in["vb"], ar, S_SCALES, F_FRAMES),
            lambda: twd.warp_depth_bwd_plain(dep, warp_in["gy"],
                                             warp_in["va"], warp_in["vb"], ar,
                                             S_SCALES, F_FRAMES),
            (px * (40.0 + 4.0 * C),
             4.0 * (3 * px * C + 2 * SB * HEIGHT * WIDTH + N * 16))),
    }
    kernels = []
    src = "fsnet_tpu_torch/csrc/"
    meta = {
        "conv3x3_bn": (src + "conv3x3.cu",
                       "fsnet_tpu/ops/pallas/conv_kernel.py:258"),
        "conv3x3_dx": (src + "conv3x3.cu",
                       "fsnet_tpu/ops/pallas/conv_kernel.py:210"),
        "conv3x3_dw": (src + "conv3x3_dw.cu",
                       "fsnet_tpu/ops/pallas/conv_kernel.py:351"),
        "warp_depth_fwd": (src + "warp_depth.cu",
                           "fsnet_tpu/ops/pallas/prep_kernel.py:190 + "
                           "fsnet_tpu/ops/pallas/warp_kernel.py:1022"),
        "warp_depth_bwd": (src + "warp_depth.cu",
                           "fsnet_tpu/ops/pallas/prep_kernel.py:277"),
    }
    for k, t in tot.items():
        b_ms, b_by = sum_bounds(t["items"])
        tc_ms, tc_by = tc_bound(sum(o for o, _ in t["items"]),
                                sum(b for _, b in t["items"]))
        entry = dict(name=k, route="cuda", source=meta[k][0],
                     replaces=meta[k][1], launches=counts[k],
                     max_abs_err=errs[k], ms=t["ms"], plain_ms=t["plain_ms"],
                     bound_ms=b_ms, bound_by=b_by, tc_bound_ms=tc_ms,
                     tc_bound_by=tc_by,
                     library_ms=t["lib_ms"] if t["lib_shapes"] else None)
        if k == "conv3x3_bn":
            entry["max_abs_err_moments"] = errs["conv3x3_bn_mom"]
        if t["lib_shapes"]:
            entry["library_shapes"] = t["lib_shapes"]
            entry["ms_library_shapes"] = t["lib_kernel_ms"]
        entry["note"] = ("sums over the shapes of one bs12 train step, "
                         "float32; bound_ms on the float32 CUDA cores, "
                         "tc_bound_ms on the 3xTF32 tensor cores"
                         + ("; library_ms: cuDNN conv backward "
                                      "(torch.nn.grad) at library_shapes, "
                                      "ms_library_shapes the kernel there"
                                      if t["lib_shapes"] else ""))
        kernels.append(entry)
    for k, (fn, plain, ob) in warp_t.items():
        b_ms, b_by = ms_bound(*ob)
        entry = dict(
            name=k, route="cuda", source=meta[k][0], replaces=meta[k][1],
            launches=counts[k], max_abs_err=errs[k],
            plain_ms=cuda_ms(plain, iters=3, warmup=1), bound_ms=b_ms,
            bound_by=b_by, library_ms=None,
            note=f"N={N} warps of {HEIGHT}x{WIDTH}x{C}, band {BAND}, "
                 "float32")
        if isinstance(fn, dict):
            time_routes(entry, fn, record["train_path"]["routes"][k])
        else:
            entry["ms"] = cuda_ms(fn, iters=10)
        kernels.append(entry)
    for e in kernels:
        print(f"time  {e['name']:15s} kernel {e['ms']:.4f} ms"
              + route_line(e) + f"  plain "
              f"{e['plain_ms']:.4f} ms  bound {e['bound_ms']:.4f} ms "
              f"({e['bound_by']})"
              + (f"  3xTF32 bound {e['tc_bound_ms']:.4f} ms "
                 f"({e['tc_bound_by']})" if "tc_bound_ms" in e else "")
              + "  library "
              + ("none" if e["library_ms"] is None else
                 f"{e['library_ms']:.4f} ms vs kernel "
                 f"{e['ms_library_shapes']:.4f} ms at "
                 f"{len(e['library_shapes'])} shapes"))
    return dict(counts=counts, kernels=kernels, batch=batch, warp_in=warp_in,
                want=want)


def grid_scene(batch_np, image, depth, mask=None):
    """The grid route's warp operands at a batch: the source frames
    ``image`` [F*B, H, W, 3], the patched masks (``mask`` [B, H, W], else
    the NuScenes ``CAM_BACK`` form: the bottom 2/9 of the rows zeroed) and
    the S*F*B reprojection grids of ``depth`` [S*B, H, W] through the
    batch's GT poses, in the loss's (s, f, b) order."""
    from fsnet_tpu_torch.ops.geometry import invert_K, make_K44, reproject

    SB, H, W = depth.shape
    S, F, B = S_SCALES, F_FRAMES, SB // S_SCALES
    N = S * F * B

    def per_warp(t):
        return t[None, None].expand(S, F, *t.shape).reshape(N, *t.shape[1:])

    K = make_K44(torch.from_numpy(batch_np["P2"]).cuda())
    Ts = torch.stack([torch.from_numpy(batch_np[f"relative_pose/{f}"])
                      for f in (1, -1)]).cuda()
    depth = depth.view(S, 1, B, H, W).expand(S, F, B, H, W)
    grid = reproject(depth.reshape(N, H, W, 1), per_warp(K),
                     per_warp(invert_K(K)),
                     Ts[None].expand(S, F, B, 4, 4).reshape(N, 4, 4))
    if mask is None:
        mask = torch.ones(B, H, W, 1, device="cuda")
        mask[:, H - (2 * H) // 9:] = 0.0
    else:
        mask = mask.to("cuda", torch.float32)[..., None].contiguous()
    return image, mask, grid.contiguous()


@functools.lru_cache(maxsize=1)
def flagship_masked_np():
    """``entry.synthetic_batch`` at bs12 @192x640 with the ``"ones"``
    patched mask, made once: its textures take the host about a minute.
    Less ``patched_mask`` it is the batch without a mask (the mask is drawn
    after all else). Phases 8-16, 32-35, 51 and 55-56 read it and change
    none of its arrays."""
    from fsnet_tpu_torch.entry import synthetic_batch

    return synthetic_batch(BATCH, HEIGHT, WIDTH, patched_mask="ones")


@functools.lru_cache(maxsize=1)
def nusc_batch_np():
    """``entry.nusc_batch()`` (bs8 @288x512, the ``"nuscenes"`` patched
    mask), made once: its textures take the host a while. Phases 12 and
    27-31 read it and change none of its arrays."""
    from fsnet_tpu_torch.entry import nusc_batch

    return nusc_batch(NUSC_BATCH, NUSC_H, NUSC_W)


def nuscenes_scene(seed=0):
    """Phase 12's second scene, at the NuScenes recipe's shape: bs8
    @288x512, 64 warps, the synthetic batch's clipped textures as sources,
    its ``"nuscenes"`` patched mask and per-scale depth in [2, 42)."""
    B, H, W = NUSC_BATCH, NUSC_H, NUSC_W
    batch_np = nusc_batch_np()
    g = torch.Generator(device="cuda").manual_seed(seed)
    image = torch.cat([torch.from_numpy(batch_np[f"original_image/{f}"])
                       for f in (1, -1)]).cuda().contiguous()
    depth = 2.0 + 40.0 * torch.rand(S_SCALES * B, H, W, generator=g,
                                    device="cuda")
    return grid_scene(batch_np, image, depth,
                      torch.from_numpy(batch_np["patched_mask"]))


def check_grid_kernels(scene, tag):
    """Phase 12 at one scene: kernels F and E (the mask) through their
    public wrappers (on the route :func:`warp_route` picks, which must be
    the row route) against their plain versions, then each launched
    ``PROJ_REPEATS`` times on the row and the narrow route in turns, every
    launch bitwise equal to the plain version. Returns their max abs errors
    and the lane-window counts."""
    from fsnet_tpu_torch.ops import warp_fast as twf

    image, mask, grid = scene
    N, H, W, _ = grid.shape
    r_f = twf.warp_route(image, grid=grid, fused=True)
    r_e = twf.warp_route(mask, grid=grid)
    check(r_f == r_e == "row", f"grid warp {tag}: routes F {r_f}, E {r_e}; "
          "both must take the row route")
    got = twf.grid_band_fused(image, grid, "border", BAND)
    ov = twf.grid_band_fwd(mask, grid, "nearest", "zeros", BAND)
    torch.cuda.synchronize()
    ref = twf.grid_band_plain(image, grid, "bilinear", "border", BAND)
    ref_ov = twf.grid_band_plain(mask, grid, "nearest", "zeros", BAND,
                                 False)[0]
    err_f = max(rel_err(a, r)[0] for a, r in zip(got, ref))
    err_e = rel_err(ov, ref_ov)[0]
    ov_diff = int(((ov == 1.0) != (ref_ov == 1.0)).sum().item())
    x = twf.unnormalize(grid[..., 0], W)
    moved = dict(photometric=lane_window_moves(x, W),
                 mask=lane_window_moves(x, W, nearest=True),
                 samples=x.numel())
    print(f"check grid warp {tag} N={N} {H}x{W} band {BAND}: kernel F "
          f"(bilinear, border, C={image.shape[-1]}, {r_f} route) max abs err "
          f"{err_f:.2e} (out, va, vb); kernel E (nearest, zeros, C=1, "
          f"{mask.shape[0]} masks, {r_e} route) max abs err {err_e:.2e}, "
          f"overlap mismatches {ov_diff}; TPU lane-window clamp would move "
          f"{moved['photometric']} (photometric) and {moved['mask']} (mask) "
          f"of {moved['samples']} samples")
    check(err_f <= 1e-6, f"kernel F: max abs err {err_f:.2e} > 1e-6")
    check(err_e <= 1e-6 and ov_diff == 0,
          f"kernel E: max abs err {err_e:.2e}, {ov_diff} overlap mismatches")
    del got, ov
    check_routes(
        f"kernel F {tag} N={N} {H}x{W}",
        lambda r: twf._launch_grid(r, image, grid, "bilinear", "border", BAND,
                                   fused=True), ref, GRID_ROUTES,
        "out, va, vb")
    check_routes(
        f"kernel E (mask) {tag} N={N} {H}x{W}",
        lambda r: (twf._launch_grid(r, mask, grid, "nearest", "zeros",
                                    BAND),), (ref_ov,), GRID_ROUTES, "out")
    return dict(warp_grid_fused=err_f, warp_grid_fwd=err_e), moved


def grid_phases(counters, record, train):
    """Phases 12-16. Returns the kernel line's entries of kernels E and F
    and the launch counts of the two grid-route paths."""
    import copy

    import torch.nn.functional as F

    from fsnet_tpu_torch.entry import (flagship_model, flagship_optimizer,
                                       learned_pose_model)
    from fsnet_tpu_torch.ops import warp_fast as twf
    from fsnet_tpu_torch.runtime.state import make_train_step

    # 12. kernels E and F against their plain versions, both routes, at the
    # flagship's scene and at a NuScenes-shaped one
    scene = grid_scene(train["batch"], train["warp_in"]["image"],
                       train["warp_in"]["depth"])
    errs, moved = check_grid_kernels(scene, "flagship")
    record["grid_lane_window_moves"] = moved
    nusc = nuscenes_scene()
    errs_n, record["nuscenes_lane_window_moves"] = check_grid_kernels(
        nusc, f"nuscenes bs{NUSC_BATCH}")
    errs = {k: max(v, errs_n[k]) for k, v in errs.items()}

    # 13. the flagship on the grid route: a batch with a patched mask
    masked = flagship_masked_np()
    want_mask = dict(train["want"], warp_depth_fwd=0, warp_depth_bwd=0,
                     warp_grid_fused=1, warp_grid_fwd=1)
    model = flagship_model(HEIGHT, WIDTH, device="cuda", seed=0)
    opt, _ = flagship_optimizer(model)
    record["grid_path_mask"] = drive_steps(model, opt, masked, counters,
                                           want_mask, "grid path (mask)")
    got = record["grid_path_mask"]["routes"]
    check(got["warp_grid_fwd"] == dict(narrow=0, vector=0, row=3)
          and got["warp_grid_fused"] == dict(narrow=0, row=3),
          f"grid path (mask): kernel E routes {got['warp_grid_fwd']}, F "
          f"{got['warp_grid_fused']}; both take the row route")
    state = copy.deepcopy(model.state_dict())
    route = {}
    for tag, b in (("grid", masked), ("depth-direct", train["batch"])):
        model.load_state_dict(state)
        o, _ = flagship_optimizer(model)
        met = make_train_step("cuda", with_grads=True)(model, o, b)
        route[tag] = (float(met["loss"]), {k: g.detach() for k, g in
                                           met["_grads"].items()})
    model.load_state_dict(state)
    loss_rel = abs(route["grid"][0] - route["depth-direct"][0]) / \
        abs(route["depth-direct"][0])
    grad_rel = grad_rel_l2(route["grid"][1], route["depth-direct"][1])
    print(f"grid route (mask of ones) vs depth-direct route, one step bs"
          f"{BATCH} from the same weights: loss {route['grid'][0]:.6f} vs "
          f"{route['depth-direct'][0]:.6f} (rel {loss_rel:.2e}), global "
          f"grad rel-L2 {grad_rel:.2e}")
    record["grid_vs_depth_route"] = dict(loss_rel=loss_rel,
                                         grad_rel_l2=grad_rel)
    check(loss_rel <= 1e-4, f"grid vs depth-direct route: loss rel "
          f"{loss_rel:.2e} > 1e-4")
    check(grad_rel < 3e-2, f"grid vs depth-direct route: grad rel-L2 "
          f"{grad_rel:.2e} >= 3e-2")

    # 14. the learned-pose MonoDepthMeta
    want_pose = dict(want_mask, warp_grid_fwd=0)
    meta = learned_pose_model(HEIGHT, WIDTH, device="cuda", seed=0)
    meta_opt, _ = flagship_optimizer(meta)
    rec = drive_steps(meta, meta_opt, train["batch"], counters, want_pose,
                      "grid path (learned pose)")
    got = rec["routes"]["warp_grid_fused"]
    check(got == dict(narrow=0, row=3), f"grid path (learned pose): kernel "
          f"F routes {got}; it takes the row route")
    pose = [n for n, _ in meta.named_parameters()
            if n.startswith(("pose_backbone.", "head.pose_decoder."))]
    stuck = [n for n in pose if n in rec["unchanged"]]
    check(not stuck, f"learned pose: parameters of the pose net did not "
          f"change: {stuck}")
    rec["pose_params"] = len(pose)
    record["grid_path_learned_pose"] = rec

    # 15. one MonoDepthMeta step at bs2 on the card against the CPU port
    small = white_noise_images({k: v[:2] for k, v in train["batch"].items()})
    record["learned_pose_card_vs_cpu"] = card_vs_cpu(
        learned_pose_model, small, "learned-pose train step")

    # 16. timings: both grid-route steps, then kernels E and F
    step = make_train_step("cuda")
    n_steps = 10
    for key, m, o, b in (("grid_step_mask", model, opt, masked),
                         ("grid_step_learned_pose", meta, meta_opt,
                          train["batch"])):
        on_card = {k: torch.from_numpy(v).cuda() for k, v in b.items()}
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            step(m, o, on_card)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step(m, o, on_card)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / n_steps * 1e3
        peak = torch.cuda.max_memory_allocated() / 1e9
        record[key] = dict(bs=BATCH, ms=ms, imgs_per_s=BATCH / ms * 1e3,
                           peak_mem_gb=peak)
        print(f"{key} bs{BATCH}@{HEIGHT}x{WIDTH} f32 (mean of {n_steps}, "
              f"batch on the card): {ms:.3f} ms = {BATCH / ms * 1e3:.2f} "
              f"imgs/s (peak memory {peak:.3f} GB)")

    image, mask, grid = scene
    N, H, W, _ = grid.shape
    C, M = image.shape[-1], mask.shape[0]
    yard = {k: (src.permute(0, 3, 1, 2).repeat(N // src.shape[0], 1, 1, 1),
                mode, pad)
            for k, src, mode, pad in (
                ("warp_grid_fused", image, "bilinear", "border"),
                ("warp_grid_fwd", mask, "nearest", "zeros"))}

    def launchers(image, mask, grid):
        return {"warp_grid_fused": {r: (
                    lambda r=r: twf._launch_grid(r, image, grid, "bilinear",
                                                 "border", BAND, fused=True))
                    for r in GRID_ROUTES},
                "warp_grid_fwd": {r: (
                    lambda r=r: twf._launch_grid(r, mask, grid, "nearest",
                                                 "zeros", BAND))
                    for r in GRID_ROUTES}}

    timed = {
        "warp_grid_fused": (
            lambda: twf.grid_band_plain(image, grid, "bilinear", "border",
                                        BAND),
            "fsnet_tpu/ops/pallas/warp_kernel.py:1022 (grid route, "
            "grid_sample_band_pallas_fused :1328) + warp_kernel.py:974",
            f"N={N} grids of {H}x{W} against {image.shape[0]} sources, C={C},"
            f" bilinear, border, band {BAND}, float32"),
        "warp_grid_fwd": (
            lambda: twf.grid_band_plain(mask, grid, "nearest", "zeros", BAND,
                                        False),
            "fsnet_tpu/ops/pallas/warp_kernel.py:752 + warp_kernel.py:1115",
            f"N={N} grids of {H}x{W} against {M} patched masks, C=1, "
            f"nearest, zeros, band {BAND}, float32"),
    }
    paths = (record["grid_path_mask"], record["grid_path_learned_pose"])
    kernels = []
    main, at_nusc = launchers(image, mask, grid), launchers(*nusc)
    for k, (plain, replaces, note) in timed.items():
        src, mode, pad = yard[k]
        b_ms, b_by = ms_bound(*grid_work(k, image, mask, grid))
        entry = dict(
            name=k, route="cuda", source="fsnet_tpu_torch/csrc/warp_grid.cu",
            replaces=replaces,
            launches=sum(p["launches"][k] for p in paths),
            max_abs_err=errs[k],
            plain_ms=cuda_ms(plain, iters=3, warmup=1),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            grid_sample_ms=cuda_ms(lambda: F.grid_sample(
                src, grid, mode=mode, padding_mode=pad, align_corners=True),
                iters=10),
            note=note + "; launches: 3 steps each of the two grid-route "
                 "paths (phases 13, 14); grid_sample_ms: F.grid_sample "
                 "(exact, no band, no va/vb) on the sources tiled to N, a "
                 "yardstick only")
        time_routes(entry, main[k],
                         {r: sum(p["routes"][k].get(r, 0) for p in paths)
                          for r in GRID_ROUTES}, GRID_ROUTES)
        # the same at phase 12's NuScenes-shaped scene, as a reading
        nb_ms, nb_by = ms_bound(*grid_work(k, *nusc))
        entry["nuscenes"] = dict(
            ms={r: [cuda_ms(at_nusc[k][r], iters=10)] for r in GRID_ROUTES},
            bound_ms=nb_ms, bound_by=nb_by,
            shape=f"N={nusc[2].shape[0]} grids of "
                  f"{NUSC_H}x{NUSC_W}, bs{NUSC_BATCH}")
        for r in GRID_ROUTES[::-1]:
            entry["nuscenes"]["ms"][r].append(cuda_ms(at_nusc[k][r],
                                                      iters=10))
        kernels.append(entry)
    for e in kernels:
        n = e["nuscenes"]
        print(f"time  {e['name']:15s} kernel {e['ms']:.4f} ms"
              + route_line(e) + f"  plain {e['plain_ms']:.4f} ms  "
              f"bound {e['bound_ms']:.4f} ms ({e['bound_by']})  "
              f"F.grid_sample {e['grid_sample_ms']:.4f} ms  library none; "
              f"nuscenes {n['shape']}: {n['ms']} bound {n['bound_ms']:.4f} "
              f"ms ({n['bound_by']})")
    return kernels


def grid_work(k, image, mask, grid):
    """(operations, bytes) of one launch of kernel F (``k`` =
    ``'warp_grid_fused'``: out, va, vb of the frames) or E (the mask) on
    these operands: about 20 operations per sample and 21 per channel for
    F, 29 per sample for E; the grid and the sources read once, the outputs
    written once."""
    N, H, W, _ = grid.shape
    px, g_bytes = N * H * W, 4.0 * grid.numel()
    if k == "warp_grid_fused":
        C = image.shape[-1]
        return (px * (20.0 + 21.0 * C),
                g_bytes + 4.0 * image.numel() + 3 * 4.0 * px * C)
    return px * 29.0, g_bytes + 4.0 * mask.numel() + 4.0 * px


def mei_scene(batch_np, seed=0):
    """Kernel G's and H's operands at the fisheye recipe: the 32 source
    frames, the 16 validity masks (ray-map mask x patched mask) and the
    fisheye batch's rays, camera and poses, with smooth per-scale norms of
    5-40 m plus a little noise (S*B = 64 maps)."""
    from fsnet_tpu_torch.ops.warp_mei import make_mei_rows

    S, B, H, W = S_SCALES, FISH_BATCH, FISH_H, FISH_W
    t = {k: torch.from_numpy(v).cuda() for k, v in batch_np.items()}
    g = torch.Generator(device="cuda").manual_seed(seed)
    image = torch.cat([t[f"original_image/{f}"] for f in (1, -1)])
    rays = t["fisheye_rays"]
    mask = rays[..., 3] * t["patched_mask"]
    i = torch.arange(H, device="cuda").view(1, H, 1) / H
    j = torch.arange(W, device="cuda").view(1, 1, W) / W
    base = 5.0 + 20.0 * torch.rand(S * B, 1, 1, generator=g, device="cuda")
    norm = base * (1.0 + 0.3 * torch.sin(4.0 * j) * torch.cos(3.0 * i)) \
        + 0.2 * torch.rand(S * B, H, W, generator=g, device="cuda")
    Ts = torch.stack([t[f"relative_pose/{f}"] for f in (1, -1)])
    rows = make_mei_rows(t["P2"], t["fisheye_params"], Ts, S)
    return (image.contiguous(), mask.contiguous(), norm.contiguous(),
            rays[..., :3].permute(0, 3, 1, 2).contiguous(), rows)


def check_mei_kernels(scene):
    """Phase 17: kernels G and H against their plain versions at the fisheye
    recipe's shapes (128 warps, 32 sources, 16 masks, band 16). Returns
    their max abs errors, the cotangent the timings reuse and the band and
    lane-window counts."""
    from fsnet_tpu_torch.ops import warp_fast as twf
    from fsnet_tpu_torch.ops import warp_mei as twm
    from fsnet_tpu_torch.ops.warp_depth import proj_route

    image, mask, norm, rays, rows = scene
    S, F, H, W = S_SCALES, F_FRAMES, FISH_H, FISH_W
    route = proj_route(*scene)
    check(route == "vector", f"kernel G at the recipe: route {route}")
    got = twm.warp_mei_fwd(image, mask, norm, rays, rows, S, F, FISH_BAND,
                           True)
    gy = torch.randn(got[0].shape, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(9))
    dn = twm.warp_mei_bwd(norm, rays, gy, got[2], got[3], rows, S, F)
    torch.cuda.synchronize()
    ref = twm.warp_mei_plain(image, mask, norm, rays, rows, S, F, FISH_BAND,
                             True)
    dn_ref = twm.warp_mei_bwd_plain(norm, rays, gy, ref[2], ref[3], rows, S,
                                    F)
    fwd = max(rel_err(a, r)[0] for a, r in zip((got[0], got[2], got[3]),
                                              (ref[0], ref[2], ref[3])))
    ov_diff = int((got[1] != ref[1]).sum().item())
    d_dn, e_dn = rel_err(dn, dn_ref)
    # samples whose corner rows the band of 16 rows does not hold, over all
    # samples and over those whose own ray is valid; rows whose band start
    # the pixels outside the fisheye disc pull below the valid pixels' one
    p = twm.mei_pix(norm, rays, rows, S, F)
    xc, yc = twm._clamp(p["x"], W - 1), twm._clamp(p["y"], H - 1)
    iw = twf.indices_and_weights(xc, yc, H, W, FISH_BAND)
    y0 = torch.floor(yc).long()
    miss = (y0 != iw["r0"]) | ((y0 + 1).clamp(max=H - 1) != iw["r1"])
    valid = mask[torch.arange(rows.shape[0], device="cuda") % mask.shape[0]]
    valid = valid > 0
    out_of_band = int(miss.sum().item())
    out_of_band_valid = int((miss & valid).sum().item())
    pulled = int((y0.amin(2) < torch.where(valid, y0, H).amin(2)).sum().item())
    moved = lane_window_moves(p["x"], W)
    n_samples = p["x"].numel()
    print(f"check Mei warp N={rows.shape[0]} {H}x{W} band {FISH_BAND}: "
          f"kernel G ({route} route) max abs err {fwd:.2e} (out, va, vb), "
          f"overlap mismatches "
          f"{ov_diff} ({int(got[1].sum().item())} of {n_samples} samples "
          f"overlap); kernel H d norm rel err {e_dn:.2e}; corner rows outside "
          f"the band: {out_of_band} of {n_samples} samples, "
          f"{out_of_band_valid} of the {int(valid.sum().item())} with a valid "
          f"ray; band start pulled down by pixels outside the disc in "
          f"{pulled} of {y0.shape[0] * H} rows; TPU lane-window clamp would "
          f"move {moved}")
    check(fwd == 0 and ov_diff == 0,
          f"kernel G: max abs err {fwd:.2e}, {ov_diff} overlap mismatches")
    check(e_dn <= 1e-6, f"kernel H: rel err {e_dn:.2e} > 1e-6")
    check_routes(
        f"kernel G N={rows.shape[0]} {H}x{W} with the mask",
        lambda r: twm._launch_fwd(r, image, mask, norm, rays, rows, S, F,
                                  FISH_BAND, True), ref)
    return (dict(warp_mei_fwd=fwd, warp_mei_bwd=d_dn), gy, got,
            dict(out_of_band=out_of_band, out_of_band_valid=out_of_band_valid,
                 rows_pulled=pulled, lane_window_moves=moved,
                 samples=n_samples))


def fisheye_phases(counters, record, train):
    """Phases 17-21. Returns the kernel line's entries of kernels G and H."""
    import copy

    import torch.nn.functional as F

    from fsnet_tpu_torch.entry import (fisheye_batch, fisheye_model,
                                       flagship_optimizer)
    from fsnet_tpu_torch.ops import warp_mei as twm
    from fsnet_tpu_torch.runtime.state import make_eval_step, make_train_step

    B, H, W = FISH_BATCH, FISH_H, FISH_W
    size = f"bs{B}@{H}x{W}"
    fb = fisheye_batch(B, H, W)

    # 17. kernels G and H, and the conv kernels at the fisheye shapes
    scene = mei_scene(fb)
    errs, gy, fwd_out, band = check_mei_kernels(scene)
    record["fisheye_band"] = band
    conv_rows = [dict(name=n) for n, *_ in FISH_SHAPES]
    record["fisheye_conv_errs"] = check_conv_kernels(B, FISH_SHAPES,
                                                     conv_rows, forward=True,
                                                     tag="fisheye")

    # 18. forward_test of the fisheye model
    model = fisheye_model(H, W, device="cuda", seed=0)
    zero(counters)
    pred = make_eval_step("cuda")(model, fb)
    torch.cuda.synchronize()
    counts = read(counters)
    check(counts["conv3x3"] == len(FISH_SHAPES)
          and all(n == 0 for k, n in counts.items() if k != "conv3x3"),
          f"fisheye forward_test launches {counts}")
    check(sorted(pred) == ["depth", "fisheye_mask", "norm"],
          f"fisheye prediction keys {sorted(pred)}")
    check(tuple(pred["depth"].shape) == tuple(pred["norm"].shape)
          == (B, H, W, 1) and tuple(pred["fisheye_mask"].shape) == (B, H, W),
          "fisheye prediction shapes")
    check(all(bool(torch.isfinite(v).all()) for v in pred.values()),
          "fisheye prediction has non-finite values")
    nmin, nmax = pred["norm"].min().item(), pred["norm"].max().item()
    check(0.1 <= nmin and nmax <= 150.0, f"norm range [{nmin}, {nmax}]")
    check(torch.equal(pred["fisheye_mask"].cpu(),
                      torch.from_numpy(fb["fisheye_rays"][..., 3])),
          "fisheye_mask is not the ray map's mask")
    print(f"fisheye path: forward_test {size} f32, {counts['conv3x3']} "
          f"conv3x3 launches, norm in [{nmin:.4f}, {nmax:.4f}], z-depth in "
          f"[{pred['depth'].min().item():.4f}, "
          f"{pred['depth'].max().item():.4f}]")
    record["fisheye_forward_test"] = dict(launches=counts["conv3x3"],
                                          norm_min=nmin, norm_max=nmax)

    # 19. the fisheye train path, three steps
    opt, _ = flagship_optimizer(model)
    want = dict(train["want"], warp_depth_fwd=0, warp_depth_bwd=0,
                warp_mei_fwd=1, warp_mei_bwd=1)
    record["fisheye_path"] = drive_steps(model, opt, fb, counters, want,
                                         "fisheye path", size=size)
    got = record["fisheye_path"]["routes"]["warp_mei_fwd"]
    check(got == dict(narrow=0, vector=3),
          f"fisheye path: kernel G routes {got}, expected its 3 launches on "
          "the vector route")

    # 20. the card against the CPU port at bs2; the norm-direct route
    # against the grid route on the card, from the same weights
    record["fisheye_card_vs_cpu"] = card_vs_cpu(
        fisheye_model, fisheye_batch(2, H, W), "fisheye train step", H, W)
    state = copy.deepcopy(model.state_dict())
    warp_all = model.head._warp_all
    route = {}
    for tag in ("norm-direct", "grid"):
        model.load_state_dict(state)
        if tag == "grid":       # without the marker of dataset poses
            model.head._warp_all = lambda i, o: (o.pop("pose_is_const"),
                                                 warp_all(i, o))[1]
        o, _ = flagship_optimizer(model)
        zero(counters)
        met = make_train_step("cuda", with_grads=True)(model, o, fb)
        torch.cuda.synchronize()
        route[tag] = (float(met["loss"]), {k: g.detach() for k, g in
                                           met["_grads"].items()},
                      read(counters), routes(counters))
    del model.head._warp_all
    model.load_state_dict(state)
    ran = {t: {k: route[t][2][k] for k in ("warp_mei_fwd", "warp_mei_bwd",
                                           "warp_grid_fused",
                                           "warp_grid_fwd")}
           for t in route}
    loss_rel = abs(route["grid"][0] - route["norm-direct"][0]) / \
        abs(route["norm-direct"][0])
    grad_rel = grad_rel_l2(route["grid"][1], route["norm-direct"][1])
    print(f"fisheye grid route vs norm-direct route, one step {size} from "
          f"the same weights: loss {route['grid'][0]:.6f} vs "
          f"{route['norm-direct'][0]:.6f} (rel {loss_rel:.2e}), global grad "
          f"rel-L2 {grad_rel:.2e}; launches {ran}")
    check(ran["norm-direct"] == dict(warp_mei_fwd=1, warp_mei_bwd=1,
                                     warp_grid_fused=0, warp_grid_fwd=0)
          and ran["grid"] == dict(warp_mei_fwd=0, warp_mei_bwd=0,
                                  warp_grid_fused=1, warp_grid_fwd=1),
          f"fisheye routes launched {ran}")
    got = {k: route["grid"][3][k] for k in ("warp_grid_fused",
                                            "warp_grid_fwd")}
    check(got == dict(warp_grid_fused=dict(narrow=0, row=1),
                      warp_grid_fwd=dict(narrow=0, vector=0, row=1)),
          f"fisheye grid route: kernels F and E took the routes {got}; both "
          "take the row route")
    record["fisheye_grid_routes"] = got
    check(loss_rel <= 1e-4, f"fisheye grid vs norm-direct route: loss rel "
          f"{loss_rel:.2e} > 1e-4")
    check(grad_rel < 3e-2, f"fisheye grid vs norm-direct route: grad rel-L2 "
          f"{grad_rel:.2e} >= 3e-2")
    record["fisheye_grid_vs_direct"] = dict(loss_rel=loss_rel,
                                            grad_rel_l2=grad_rel)

    # 21. timings: the fisheye step, then kernels G and H
    step = make_train_step("cuda")
    on_card = {k: torch.from_numpy(v).cuda() for k, v in fb.items()}
    n_steps = 10
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        step(model, opt, on_card)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        step(model, opt, on_card)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n_steps * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    record["fisheye_step"] = dict(bs=B, ms=ms, imgs_per_s=B / ms * 1e3,
                                  peak_mem_gb=peak)
    print(f"fisheye_step {size} f32 (mean of {n_steps}, batch on the card): "
          f"{ms:.3f} ms = {B / ms * 1e3:.2f} imgs/s (peak memory "
          f"{peak:.3f} GB)")

    image, mask, norm, rays, rows = scene
    S, Fr, N, C = S_SCALES, F_FRAMES, rows.shape[0], image.shape[-1]
    px, plane = N * H * W, H * W
    SB, FB = norm.shape[0], image.shape[0]
    p = twm.mei_pix(norm, rays, rows, S, Fr)
    grid = torch.stack([p["x"] / (W - 1) * 2.0 - 1.0,
                        p["y"] / (H - 1) * 2.0 - 1.0], dim=-1).contiguous()
    src = image.permute(0, 3, 1, 2).repeat(N // FB, 1, 1, 1)
    del p
    _, _, va, vb = fwd_out
    # operations per sample: the projection 51, corners and fractions 10,
    # 15 per channel, the mask and the overlap 19; the cotangent: the
    # projection and its derivative 89, 4 per channel, masks and sum 12
    timed = {
        "warp_mei_fwd": (
            {r: (lambda r=r: twm._launch_fwd(r, image, mask, norm, rays, rows,
                                             S, Fr, FISH_BAND, True))
             for r in PROJ_ROUTES},
            lambda: twm.warp_mei_plain(image, mask, norm, rays, rows, S, Fr,
                                       FISH_BAND, True),
            (px * (80.0 + 15.0 * C),
             4.0 * (SB * plane + 3 * FB // Fr * plane + FB * plane * C
                    + mask.numel() + N * 24) + px * (3 * 4.0 * C + 1)),
            "fsnet_tpu/ops/pallas/mei_prep_kernel.py:99 + "
            "fsnet_tpu/ops/pallas/warp_kernel.py:1022 (both sweeps of "
            "fsnet_tpu/ops/warp_mei.py:115-141)"),
        "warp_mei_bwd": (
            lambda: twm.warp_mei_bwd(norm, rays, gy, va, vb, rows, S, Fr),
            lambda: twm.warp_mei_bwd_plain(norm, rays, gy, va, vb, rows, S,
                                           Fr),
            (px * (101.0 + 4.0 * C),
             4.0 * (2 * SB * plane + 3 * FB // Fr * plane + 3 * px * C
                    + N * 24)),
            "fsnet_tpu/ops/pallas/mei_prep_kernel.py:209"),
    }
    kernels = []
    launches = record["fisheye_path"]["launches"]
    for k, (fn, plain, ob, replaces) in timed.items():
        b_ms, b_by = ms_bound(*ob)
        entry = dict(
            name=k, route="cuda", source="fsnet_tpu_torch/csrc/warp_mei.cu",
            replaces=replaces, launches=launches[k], max_abs_err=errs[k],
            plain_ms=cuda_ms(plain, iters=3, warmup=1),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            note=f"N={N} warps of {H}x{W}x{C} (S={S}, F={Fr}, B={B}), band "
                 f"{FISH_BAND}, float32; launches: 3 steps of the fisheye "
                 "path (phase 19)")
        if isinstance(fn, dict):
            time_routes(entry, fn, record["fisheye_path"]["routes"][k])
        else:
            entry["ms"] = cuda_ms(fn, iters=10)
        kernels.append(entry)
    kernels[0]["grid_sample_ms"] = cuda_ms(lambda: F.grid_sample(
        src, grid, mode="bilinear", padding_mode="border",
        align_corners=True), iters=10)
    kernels[0]["note"] += ("; grid_sample_ms: F.grid_sample (exact, no band, "
                           "no va/vb, no mask) of the sources tiled to N at "
                           "the Mei grid, a yardstick only")
    for e in kernels:
        print(f"time  {e['name']:15s} kernel {e['ms']:.4f} ms"
              + route_line(e) + f"  plain "
              f"{e['plain_ms']:.4f} ms  bound {e['bound_ms']:.4f} ms "
              f"({e['bound_by']})"
              + (f"  F.grid_sample {e['grid_sample_ms']:.4f} ms"
                 if "grid_sample_ms" in e else "") + "  library none")
    return kernels, launches, dict(scene=scene, batch=fb)


DLA_BAND = 8


def dcn_scene(model, x):
    """(module, input, grid, offsets) of each deformable conv of ``model``
    in a train-mode forward of ``x`` without grad (the BN statistics
    restored after), the grid from the module's own (perturbed) offset
    conv: the operands the main path gives kernels E and K."""
    import copy

    from fsnet_tpu_torch.models.backbones.dla_utils import \
        ModulatedDeformConvPack
    from fsnet_tpu_torch.ops.dcn import tap_grid

    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda m, a: seen.append((m, a[0].contiguous())))
        for m in model.modules() if isinstance(m, ModulatedDeformConvPack)]
    state = copy.deepcopy(model.state_dict())
    with torch.no_grad():
        model.dummy_forward(x, train=True)
        out = []
        for m, inp in seen:
            K = m.weight.shape[0]
            off = m.conv_offset(inp)[..., :2 * K * K]
            out.append((m, inp, tap_grid(off, inp.shape[1], inp.shape[2], K,
                                         m.stride, m.padding, m.dilation),
                        off))
    model.load_state_dict(state)
    for h in hooks:
        h.remove()
    return out


def band_misses(grid, H, W, band):
    """Samples of a bilinear zeros-padded warp with a weighted corner row
    that the band of ``band`` rows does not hold (it reads the band's edge
    row instead)."""
    from fsnet_tpu_torch.ops import warp_fast as twf

    x, y = twf.unnormalize(grid[..., 0], W), twf.unnormalize(grid[..., 1], H)
    iw = twf.indices_and_weights(x, y, H, W, band, "bilinear", "zeros")
    y0 = torch.floor(y)
    miss = (((iw["r0"] != y0.clamp(0, H - 1)) & (iw["wy0"] != 0))
            | ((iw["r1"] != (y0 + 1).clamp(0, H - 1)) & (iw["wy1"] != 0)))
    return int(miss.sum().item())


# phase 23 launches kernels E and K this many times per DCN shape
WARP_REPEATS = 4


def check_dcn_kernels(scene):
    """Phase 23: kernels E and K against their plain versions at the 16 DCN
    shapes, each launched :data:`WARP_REPEATS` times: E bitwise equal to
    its plain version (and so launch to launch), K within 1e-5 of each
    output's largest entry at every launch and its gfx, gfy bitwise equal
    launch to launch (dimage's atomic sums run in no fixed order). Returns
    the max errors, per-shape rows and the cotangents the timings reuse."""
    from fsnet_tpu_torch.ops import warp_fast as twf

    errs = dict(warp_grid_fwd=0.0, warp_grid_bwd=0.0)
    rows, cots = [], []
    tot = dict(samples=0, misses=0)
    gen = torch.Generator(device="cuda").manual_seed(23)
    for i, (m, x, grid, _) in enumerate(scene):
        _, H, W, C = x.shape
        band = min(DLA_BAND, H)
        ref = twf.grid_band_plain(x, grid, "bilinear", "zeros", band,
                                  False)[0]
        g = torch.randn(ref.shape, device="cuda", generator=gen)
        refs = twf.grid_band_bwd_plain(x, grid, g, "bilinear", "zeros", band)
        before = (dict(twf.grid_band_fwd.routes),
                  dict(twf.grid_band_bwd.routes))
        e_fwd, first, bitwise = 0.0, None, True
        e_bwd, d_bwd = [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]  # relative, abs
        for _ in range(WARP_REPEATS):
            out = twf.grid_band_fwd(x, grid, "bilinear", "zeros", band)
            got = twf.grid_band_bwd(x, grid, g, "bilinear", "zeros", band)
            torch.cuda.synchronize()
            e_fwd = max(e_fwd, rel_err(out, ref)[0])
            bitwise = bitwise and torch.equal(out, ref)
            for k, (a, r) in enumerate(zip(got, refs)):
                d, e = rel_err(a, r)
                d_bwd[k], e_bwd[k] = max(d_bwd[k], d), max(e_bwd[k], e)
            if first is None:
                first = got[:2]
            check(all(torch.equal(a, b) for a, b in zip(got[:2], first)),
                  f"DCN {i}: kernel K's gfx, gfy differ launch to launch")
            del out, got
        route = [next(k for k, n in fn.routes.items() if n != was[k])
                 for fn, was in zip((twf.grid_band_fwd, twf.grid_band_bwd),
                                    before)]
        del ref, refs, first
        misses = band_misses(grid, H, W, band)
        tot["samples"] += grid[..., 0].numel()
        tot["misses"] += misses
        row = dict(input=list(x.shape), cout=m.weight.shape[-1],
                   grid=list(grid.shape), band=band, routes=route,
                   fwd_max_abs_err=e_fwd, fwd_bitwise=bitwise,
                   bwd_rel_err=e_bwd, band_misses=misses,
                   samples=grid[..., 0].numel())
        rows.append(row)
        errs["warp_grid_fwd"] = max(errs["warp_grid_fwd"], e_fwd)
        errs["warp_grid_bwd"] = max(errs["warp_grid_bwd"], *d_bwd)
        print(f"check DCN {i:2d} {tuple(x.shape)} -> {row['cout']}: kernel E "
              f"({route[0]} route) max abs err {e_fwd:.2e}, bitwise "
              f"{bitwise}; kernel K ({route[1]} route) rel err gfx "
              f"{e_bwd[0]:.2e} gfy {e_bwd[1]:.2e} dimage {e_bwd[2]:.2e}; "
              f"x{WARP_REPEATS} launches; {misses} of {row['samples']} "
              f"samples outside the band of {band}")
        check(e_fwd <= 1e-6 and bitwise,
              f"DCN {i}: kernel E max abs err {e_fwd:.2e}, bitwise {bitwise}")
        check(all(e <= 1e-5 for e in e_bwd),
              f"DCN {i}: kernel K rel errs {e_bwd} > 1e-5")
        check(route == ["vector", "vector"], f"DCN {i}: kernels E and K took "
              f"the {route} routes, not the channel-wide one")
        cots.append(g)
    share = tot["misses"] / tot["samples"]
    print(f"DCN samples outside the band of {DLA_BAND} rows: {tot['misses']}"
          f" of {tot['samples']} ({share:.4%})")
    return errs, rows, cots, dict(tot, share=share)


def train_mode_spread(batch, H=HEIGHT, W=WIDTH):
    """A reading, not a gate: the train-mode DLA step (batch statistics) on
    the card against the CPU port, and the CPU port's float32 step against
    its float64 step. At random init float32 rounding alone moves this
    step's gradient by several percent (the bilinear warp's and ReLU's
    kinks, where float32 and float64 pick different sides;
    ``scripts/dla_conditioning.py``), so only the loss is held, to 1e-4."""
    from fsnet_tpu_torch.entry import dla_model

    l_card, g_card, _ = one_step(dla_model, batch, "cuda", H, W)
    l_cpu, g_cpu, _ = one_step(dla_model, batch, "cpu", H, W)
    l64, g64, _ = one_step(dla_model, batch, "cpu", H, W, torch.float64)
    out = dict(loss_rel=abs(l_card - l_cpu) / abs(l_cpu),
               grad_rel_l2=grad_rel_l2(g_card, g_cpu),
               card_vs_f64_grad_rel_l2=grad_rel_l2(g_card, g64),
               cpu_f32_vs_f64_loss_rel=abs(l_cpu - l64) / abs(l64),
               cpu_f32_vs_f64_grad_rel_l2=grad_rel_l2(g_cpu, g64))
    print(f"reading: DLA train step in train mode bs2@{H}x{W}, card vs CPU "
          f"port: loss rel {out['loss_rel']:.2e}, global grad rel-L2 "
          f"{out['grad_rel_l2']:.2e}; card vs CPU float64 "
          f"{out['card_vs_f64_grad_rel_l2']:.2e}; CPU float32 vs float64: "
          f"loss rel {out['cpu_f32_vs_f64_loss_rel']:.2e}, global grad rel-L2"
          f" {out['cpu_f32_vs_f64_grad_rel_l2']:.2e}")
    check(out["loss_rel"] <= 1e-4, f"DLA train mode: card vs CPU loss rel "
          f"{out['loss_rel']:.2e} > 1e-4")
    return out


def dla_phases(counters, record):
    """Phases 23-26. Returns the kernel line's entry of kernel K and E's
    numbers on the DLA path."""
    import torch.nn.functional as F

    from fsnet_tpu_torch.entry import (dla_batch, dla_model,
                                       flagship_optimizer)
    from fsnet_tpu_torch.ops import warp_fast as twf
    from fsnet_tpu_torch.runtime.state import make_eval_step, make_train_step

    B, H, W = BATCH, HEIGHT, WIDTH
    size = f"bs{B}@{H}x{W}"
    batch = dla_batch(B, H, W)
    on_card = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    model = dla_model(H, W, device="cuda", seed=0)
    n_params = sum(p.numel() for p in model.parameters())

    # 23. kernels E and K against their plain versions at the DCN shapes
    scene = dcn_scene(model, on_card["image/0"])
    check(len(scene) == 16, f"{len(scene)} deformable convs, expected 16")
    errs, rows, cots, band = check_dcn_kernels(scene)
    record["dla_dcn_shapes"] = rows
    record["dla_band"] = band

    # 24. serving: the train=False forward
    eval_step = make_eval_step("cuda")
    zero(counters)
    pred = eval_step(model, batch)["features"]
    torch.cuda.synchronize()
    counts = read(counters)
    want_eval = {k: 0 for k in counts}
    want_eval["warp_grid_fwd"] = len(scene)
    check(counts == want_eval, f"DLA forward launches {counts}, expected "
          f"{want_eval}")
    got = routes(counters)["warp_grid_fwd"]
    check(got == dict(narrow=0, vector=len(scene), row=0), f"DLA forward: "
          f"kernel E routes {got}, expected all {len(scene)} channel-wide")
    check(tuple(pred.shape) == (B, H // 4, W // 4, 64)
          and bool(torch.isfinite(pred).all()),
          f"DLA output {tuple(pred.shape)}, finite "
          f"{bool(torch.isfinite(pred).all())}")
    print(f"DLA path: forward {size} f32 ({n_params} parameters), launches "
          f"{counts}, output {tuple(pred.shape)} in "
          f"[{pred.min().item():.4f}, {pred.max().item():.4f}]")
    record["dla_forward"] = dict(launches=counts, routes=routes(counters),
                                 params=n_params)

    # 25. three train steps, then one at bs2 on the card against the CPU
    opt, _ = flagship_optimizer(model)
    want = dict(want_eval, warp_grid_bwd=len(scene))
    record["dla_path"] = drive_steps(model, opt, batch, counters, want,
                                     "DLA train path", size=size)
    for k in ("warp_grid_fwd", "warp_grid_bwd"):
        got = record["dla_path"]["routes"][k]
        check(got == dict.fromkeys(got, 0) | dict(vector=3 * len(scene)),
              f"DLA train path: {k} routes {got}, expected all channel-wide")
    small = {k: v[:2] for k, v in batch.items()}
    record["dla_card_vs_cpu"] = card_vs_cpu(
        functools.partial(dla_model, norm_frozen=True), small,
        "DLA train step, BN on its init statistics")
    record["dla_train_mode_spread"] = train_mode_spread(small)

    # 26. timings: kernels E and K per step, then (the scene freed, so the
    # peak is the step's own) the step and the forward
    t = {k: dict(ms=0.0, plain_ms=0.0, ops=0.0, nbytes=0.0, yard_ms=0.0)
         for k in ("warp_grid_fwd", "warp_grid_bwd")}
    for i, ((m, x, grid, _), g) in enumerate(zip(scene, cots)):
        _, Hi, Wi, C = x.shape
        band = min(DLA_BAND, Hi)
        N = grid.shape[0]
        px = grid[..., 0].numel()
        src = x.permute(0, 3, 1, 2).repeat(N // x.shape[0], 1, 1, 1)
        gc = g.permute(0, 3, 1, 2)
        # operations per sample: corners and weights 20; per channel the
        # blend 6 (E), and 10 for va and vb, 4 for the sums against g and
        # 6 for the four scattered products (K)
        for k, fn, plain, ops, nbytes, yard in (
                ("warp_grid_fwd",
                 lambda: twf.grid_band_fwd(x, grid, "bilinear", "zeros", band),
                 lambda: twf.grid_band_plain(x, grid, "bilinear", "zeros",
                                             band, False),
                 px * (20.0 + 6.0 * C),
                 4.0 * (x.numel() + grid.numel() + px * C),
                 lambda: F.grid_sample(src, grid, mode="bilinear",
                                       padding_mode="zeros",
                                       align_corners=True)),
                ("warp_grid_bwd",
                 lambda: twf.grid_band_bwd(x, grid, g, "bilinear", "zeros",
                                           band),
                 lambda: twf.grid_band_bwd_plain(x, grid, g, "bilinear",
                                                 "zeros", band),
                 px * (20.0 + 20.0 * C),
                 4.0 * (2 * x.numel() + grid.numel() + px * C + 2 * px),
                 lambda: torch.ops.aten.grid_sampler_2d_backward(
                     gc, src, grid, 0, 0, True, [True, True]))):
            ms, host = cuda_host_ms(fn, iters=10)
            b_ms, b_by = ms_bound(ops, nbytes)
            rows[i][k] = dict(ms=ms, host_ms=host, bound_ms=b_ms,
                              bound_by=b_by)
            t[k]["ms"] += ms
            t[k]["plain_ms"] += cuda_ms(plain, iters=2, warmup=1)
            t[k]["yard_ms"] += cuda_ms(yard, iters=10)
            t[k]["ops"] += ops
            t[k]["nbytes"] += nbytes
        ei, ki = rows[i]["warp_grid_fwd"], rows[i]["warp_grid_bwd"]
        print(f"time  DCN {i:2d} {tuple(x.shape)} x{N // x.shape[0]} taps: "
              f"kernel E {ei['ms']:.4f} ms (host {ei['host_ms']:.4f} ms a "
              f"call, bound {ei['bound_ms']:.4f}), kernel K "
              f"{ki['ms']:.4f} ms (host {ki['host_ms']:.4f}, bound "
              f"{ki['bound_ms']:.4f})")
        del src, gc
    del scene, cots, m, x, grid, g, pred
    step = make_train_step("cuda")
    n_steps = 10
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 1e9
    for _ in range(2):
        step(model, opt, on_card)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        step(model, opt, on_card)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n_steps * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    fwd = cuda_ms(lambda: eval_step(model, on_card), iters=10)
    record["dla_step"] = dict(bs=B, ms=ms, imgs_per_s=B / ms * 1e3,
                              peak_mem_gb=peak, held_before_gb=held,
                              forward_ms=fwd,
                              forward_imgs_per_s=B / fwd * 1e3)
    print(f"dla_step {size} f32 (mean of {n_steps}, batch on the card): "
          f"{ms:.3f} ms = {B / ms * 1e3:.2f} imgs/s (peak memory "
          f"{peak:.3f} GB, {held:.3f} GB of it allocated before the first "
          "step: the model, its optimizer state, the batch and what earlier "
          f"phases hold); forward {fwd:.3f} ms = {B / fwd * 1e3:.2f} imgs/s")

    for k in t:
        t[k]["bound_ms"], t[k]["bound_by"] = ms_bound(t[k]["ops"],
                                                      t[k]["nbytes"])
    launches = record["dla_path"]["launches"]
    tk = t["warp_grid_bwd"]
    kernel_k = dict(
        name="warp_grid_bwd", route="cuda",
        source="fsnet_tpu_torch/csrc/warp_grad.cu",
        replaces="fsnet_tpu/ops/pallas/warp_kernel.py:815 + "
                 "warp_kernel.py:1169",
        launches=launches["warp_grid_bwd"],
        warp_route=taken(record["dla_path"]["routes"]["warp_grid_bwd"]),
        max_abs_err=errs["warp_grid_bwd"], ms=tk["ms"],
        plain_ms=tk["plain_ms"], bound_ms=tk["bound_ms"],
        bound_by=tk["bound_by"], library_ms=None,
        grid_sampler_2d_backward_ms=tk["yard_ms"],
        note=f"sums over the 16 DCNs of one {size} step (9 taps each as one "
             f"grid batch of 9 x {B}), bilinear, zeros, band {DLA_BAND}, "
             "float32; launches: 3 steps of the DLA path (phase 25); "
             "warp_route: the route those launches took (channel-wide: "
             "float4 lanes, vector atomics; narrow: scalar); "
             "grid_sampler_2d_backward_ms: torch's exact backward (no band) "
             "on the inputs tiled to the grid batch, a yardstick only")
    te = t["warp_grid_fwd"]
    e_dla = dict(dla_launches=launches["warp_grid_fwd"],
                 dla_warp_route=taken(
                     record["dla_path"]["routes"]["warp_grid_fwd"]),
                 dla_max_abs_err=errs["warp_grid_fwd"], dla_ms=te["ms"],
                 dla_plain_ms=te["plain_ms"], dla_bound_ms=te["bound_ms"],
                 dla_bound_by=te["bound_by"], dla_grid_sample_ms=te["yard_ms"])
    for name, e in (("K (bwd)", tk), ("E (fwd)", te)):
        print(f"time  DLA kernel {name} summed over 16 DCNs: {e['ms']:.4f} ms"
              f"  plain {e['plain_ms']:.4f} ms  bound {e['bound_ms']:.4f} ms"
              f" ({e['bound_by']})  yardstick {e['yard_ms']:.4f} ms  "
              "library none")
    return kernel_k, e_dla


# operations per pixel-channel of the photometric loss: the forward pools
# three quantities (54), the SSIM terms (17), the clip, L1 and channel sums
# (about 9); the cotangent adds the partials (35) and the adjoint of three
# pools (about 60)
PHOTO_OPS = dict(fwd=80.0, bwd=150.0)
# the vector route's tiles (csrc/photo_loss.cu): a lane's 4 pixels of a
# row; J computes its partials on 8 pooled rows for 6 output rows
PHOTO_LANE_PIXELS = 4
PHOTO_J_ROWS = (8, 6)
PHOTO_ROUTES = ("vector", "narrow")
# per step of each photometric train path (phases 9, 13, 14, 19): kernel I
# twice, kernel J once, all on the vector route
PHOTO_PATHS = dict(train_path="depth-direct", grid_path_mask="grid (mask)",
                   grid_path_learned_pose="learned pose",
                   fisheye_path="fisheye")


def photo_ties(pred, target, muy, sy):
    """Exact ties of the loss's gates over the pixel-channels of ``pred``:
    zero variance (the clamp), SSIM dissimilarity at 0 and at 1 (the clip),
    and pred == target (the L1 sign)."""
    from fsnet_tpu_torch.ops import photo_loss as tpl

    t = tpl._terms(pred, target, muy, sy)
    return dict(variance=int((t["sx_raw"] == 0).sum()),
                clip0=int((t["val"] == 0).sum()),
                clip1=int((t["val"] == 1).sum()),
                equal=int((t["x"] == target).sum()), values=pred.numel())


def check_photo_kernels(recipe, stacks, target, seed, autograd_gate=True):
    """Phase 22 at one recipe (and phase 28 at the nuScenes step): the
    photometric kernels of both routes against their plain versions on the
    loss's own operands, the warped stack and the identity stack against
    ``target`` (n mod B): the forward bitwise equal on the vector route and
    within 1e-6 of the largest loss on the narrow one (the share of
    bitwise-equal pixels printed), the cotangent of the warped stack within
    1e-5 of its largest entry against the plain cotangent and against
    autograd of the plain forward on the card, for each of 4 seeded loss
    cotangents (autograd held at the first only, and there only with
    ``autograd_gate``, the vector route bitwise equal to the plain
    cotangent at each); the ties each stack holds.
    Returns the max abs errors by route, the ties, the timings by route
    (with the plain versions', the bound and the host's time to issue one
    call) and the cotangent's errors by route and seed."""
    from fsnet_tpu_torch.ops import photo_loss as tpl
    from fsnet_tpu_torch.ops.ssim import ssim_target_stats

    muy, sy = ssim_target_stats(target)
    B = target.shape[0]
    errs = {r: dict(photo_loss_fwd=0.0, photo_loss_bwd=0.0)
            for r in PHOTO_ROUTES}
    ties, timed, elems = {}, dict(fwd=[], bwd=[]), dict(fwd=0, bwd=0)
    bwd_errs = {r: [] for r in PHOTO_ROUTES}
    for kind, pred in stacks.items():
        N, H, W, C = pred.shape
        check(tpl.photo_route(pred, target, muy, sy) == "vector",
              f"{recipe} {kind}: the main path's operands miss the vector "
              "route")
        ref = tpl.photo_loss_plain(pred, target, muy, sy)
        ties[kind] = photo_ties(pred, target, muy, sy)
        line = (f"check photometric loss, {recipe} {kind} stack N={N} "
                f"{H}x{W}x{C} against B={B}:")
        for route in PHOTO_ROUTES:
            got = tpl._launch_fwd(route, pred, target, muy, sy)
            torch.cuda.synchronize()
            d, e = rel_err(got, ref)
            equal = float((got == ref).double().mean())
            errs[route]["photo_loss_fwd"] = max(
                errs[route]["photo_loss_fwd"], d)
            line += (f" {route} forward max abs err {d:.2e} (rel {e:.2e}), "
                     f"bitwise-equal pixels {equal:.6f};")
            check(e <= 1e-6 and (route != "vector" or equal == 1.0),
                  f"photo_loss_fwd {route} {recipe} {kind}: rel err {e:.2e}"
                  f", bitwise-equal share {equal} (the vector route must be "
                  "bitwise, the narrow one within 1e-6)")
        px = N * H * W * C
        elems["fwd"] += px
        nbytes = 4.0 * (px + 3 * B * H * W * C + N * H * W)
        timed["fwd"].append(dict(
            route={r: (lambda p=pred, r=r: tpl._launch_fwd(r, p, target, muy,
                                                           sy))
                   for r in PHOTO_ROUTES},
            plain=lambda p=pred: tpl.photo_loss_plain(p, target, muy, sy),
            wrapper=lambda p=pred: tpl.photo_loss_fwd(p, target, muy, sy),
            work=(PHOTO_OPS["fwd"] * px, nbytes)))
        if kind == "warped":
            for k in range(4):
                g = torch.randn(N, H, W, device="cuda",
                                generator=torch.Generator(
                                    device="cuda").manual_seed(seed + k))
                ref_dx = tpl.photo_loss_bwd_plain(pred, target, muy, sy, g)
                xr = pred.clone().requires_grad_(True)
                tpl.photo_loss_plain(xr, target, muy, sy).backward(g)
                for route in PHOTO_ROUTES:
                    dx = tpl._launch_bwd(route, pred, target, muy, sy, g)
                    torch.cuda.synchronize()
                    d_b, e_b = rel_err(dx, ref_dx)
                    e_a = rel_err(dx, xr.grad)[1]
                    equal = float((dx == ref_dx).double().mean())
                    errs[route]["photo_loss_bwd"] = max(
                        errs[route]["photo_loss_bwd"], d_b)
                    bwd_errs[route].append(dict(
                        seed=seed + k, plain=e_b, autograd=e_a, equal=equal))
                    line += (f" {route} cotangent (seed {seed + k}) rel err "
                             f"{e_b:.2e} against the plain cotangent "
                             f"(bitwise-equal share {equal:.6f}), {e_a:.2e} "
                             "against autograd of the plain forward;")
                    # the gate: the plain cotangent at every seed (the
                    # vector route bitwise), autograd at the first seed;
                    # at the others autograd is a reading, since the
                    # plain cotangent and autograd, both float32, round
                    # apart by about 1e-5 of the largest entry themselves
                    check(e_b <= 1e-5 and (k > 0 or not autograd_gate
                                           or e_a <= 1e-5)
                          and (route != "vector" or equal == 1.0),
                          f"photo_loss_bwd {route} {recipe} seed {seed + k}: "
                          f"rel err {e_b:.2e} (plain, bitwise-equal share "
                          f"{equal}), {e_a:.2e} (autograd): > 1e-5, or the "
                          "vector route not bitwise")
                    del dx
                del xr
            elems["bwd"] += px
            timed["bwd"].append(dict(
                route={r: (lambda p=pred, r=r: tpl._launch_bwd(
                    r, p, target, muy, sy, g)) for r in PHOTO_ROUTES},
                plain=lambda p=pred: tpl.photo_loss_bwd_plain(
                    p, target, muy, sy, g),
                wrapper=lambda p=pred: tpl.photo_loss_bwd(p, target, muy, sy,
                                                          g),
                work=(PHOTO_OPS["bwd"] * px, nbytes + 4.0 * px)))
        print(line + f" ties {ties[kind]}")
    times = {}
    for k, items in timed.items():
        b_ms, b_by = sum_bounds([it["work"] for it in items])
        # the routes in turns: vector, narrow, narrow, vector
        ms = {r: [] for r in PHOTO_ROUTES}
        for r in PHOTO_ROUTES + PHOTO_ROUTES[::-1]:
            ms[r].append(sum(cuda_ms(it["route"][r], iters=10)
                             for it in items))
        # the host's time to issue one call, at the warped stack (the
        # first): the public wrapper (the main path's, vector route) and
        # the narrow route's launcher
        host_ms = dict(
            wrapper=cuda_host_ms(items[0]["wrapper"], iters=20)[1],
            narrow_launcher=cuda_host_ms(items[0]["route"]["narrow"],
                                         iters=20)[1])
        times[k] = dict(ms={r: v for r, v in ms.items()},
                        plain_ms=sum(cuda_ms(it["plain"], iters=3, warmup=1)
                                     for it in items),
                        bound_ms=b_ms, bound_by=b_by, elems=elems[k],
                        host_ms=host_ms)
    return errs, ties, times, bwd_errs


def photo_occupancy(dtype=0):
    """Dynamic shared memory per block and resident blocks per SM of the
    vector route's two kernels at C = 3, in float32 (``dtype`` 0) or
    bfloat16 (1, whose staged tiles are float32 as the float32 kernels'),
    by the runtime."""
    import ctypes

    from fsnet_tpu_torch.ops import _build

    fn = _build.load("photo_loss").fsnet_photo_loss_vec_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    occ = {}
    for bwd, tag in ((0, "fwd"), (1, "bwd")):
        smem = ctypes.c_int(0)
        blocks = fn(bwd, 3, dtype, ctypes.byref(smem))
        name = f"photo_loss_{tag}_vec_kernel<3{', bf16' if dtype else ''}>"
        check(blocks > 0, f"occupancy of {name}: {blocks}")
        occ[tag] = dict(dynamic_smem=smem.value, blocks_per_sm=blocks)
        print(f"kernel {name}: {occ[tag]}")
    return occ


def photo_fp32_per_elem(sass, C=3):
    """FP32 instructions per output pixel-channel of the vector route's
    kernels at C channels, from this run's SASS (phase 2): I's stretch
    after its one barrier (the loop body: a lane's row of 4 C elements for
    one prediction); J's stretch after its first barrier (phase 1: a
    pooled row) times 8 pooled rows over 6 output rows, plus its stretch
    after the second (phase 2: an output row)."""
    e = PHOTO_LANE_PIXELS * C
    fwd = sass[f"photo_loss_fwd_vec_kernel<{C}>"]["after_bar"]
    bwd = sass[f"photo_loss_bwd_vec_kernel<{C}>"]["after_bar"]
    check(len(fwd) == 1 and len(bwd) == 3,
          f"the vector kernels' SASS has {len(fwd)} and {len(bwd)} barriers, "
          "not 1 and 3: their per-element FP32 counts need another reading")
    pooled, rows = PHOTO_J_ROWS
    return dict(fwd=fwd[0][1] / e,
                bwd=bwd[0][1] / e * pooled / rows + bwd[1][1] / e)


def photo_phases(record, train, fish):
    """Phase 22. Returns the kernel line's entries of the photometric
    kernels."""
    from fsnet_tpu_torch.ops import warp_depth as twd
    from fsnet_tpu_torch.ops import warp_mei as twm

    # every photometric train path ran I 2 + J 1 per step, all on the
    # vector route
    for key, name in PHOTO_PATHS.items():
        rec = record[key]
        for k, per_step in (("photo_loss_fwd", 2), ("photo_loss_bwd", 1)):
            got = rec["routes"][k]
            check(got == dict(narrow=0, vector=per_step * rec["steps"]),
                  f"{name} path: {k} routes {got}, expected {per_step} a "
                  f"step on the vector route over {rec['steps']} steps")
    print("routes: every photometric train path ran kernel I 2 + J 1 per "
          "step on the vector route")
    record["photo_occupancy"] = occ = photo_occupancy()
    fp32 = photo_fp32_per_elem(record["photo_sass"])
    record["photo_fp32_per_elem"] = fp32

    # the flagship: the warped stack of phase 8's scene (the synthetic
    # batch's clipped textures) and its 24 sources, against its 12 targets
    wi = train["warp_in"]
    warped = twd.warp_depth_fwd(wi["image"], wi["depth"], wi["arows"],
                                S_SCALES, F_FRAMES, BAND)[0]
    target = torch.from_numpy(train["batch"]["original_image/0"]).cuda()
    flag = check_photo_kernels(f"bs{BATCH}@{HEIGHT}x{WIDTH}",
                               dict(warped=warped, identity=wi["image"]),
                               target, seed=11)
    del warped
    # the fisheye recipe: kernel G's warped stack of phase 17's scene
    image, mask, norm, rays, rows = fish["scene"]
    warped = twm.warp_mei_fwd(image, mask, norm, rays, rows, S_SCALES,
                              F_FRAMES, FISH_BAND, True)[0]
    target = torch.from_numpy(fish["batch"]["original_image/0"]).cuda()
    fisheye = check_photo_kernels(
        f"bs{FISH_BATCH}@{FISH_H}x{FISH_W}",
        dict(warped=warped, identity=image), target, seed=12)
    del warped
    record["photo_ties"] = dict(flagship=flag[1], fisheye=fisheye[1])
    record["photo_bwd_errs"] = dict(flagship=flag[3], fisheye=fisheye[3])
    for r in PHOTO_ROUTES:
        worst = {k: max(max(e[k] for e in x[3][r]) for x in (flag, fisheye))
                 for k in ("plain", "autograd")}
        print(f"cotangent {r} route over 4 seeds at both recipes: largest "
              f"rel err {worst['plain']:.2e} against the plain cotangent, "
              f"{worst['autograd']:.2e} against autograd (gate 1e-5)")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.split("\n")[0].split(",")
    clock_mhz, max_mhz = float(smi[0]), float(smi[1])
    lanes = torch.cuda.get_device_properties(0).multi_processor_count * 128
    kernels = []
    for k, tag, replaces in (
            ("photo_loss_fwd", "fwd",
             "fsnet_tpu/ops/pallas/photo_kernel.py:324"),
            ("photo_loss_bwd", "bwd",
             "fsnet_tpu/ops/pallas/photo_kernel.py:370")):
        t, tf = flag[2][tag], fisheye[2][tag]
        floor = {r: fp32[tag] * x[2][tag]["elems"]
                 / (lanes * max_mhz * 1e6) * 1e3
                 for r, x in (("flagship", flag), ("fisheye", fisheye))}
        vec = "fwd_vec" if tag == "fwd" else "bwd_vec"
        kernels.append(dict(
            name=k, route="cuda", source="fsnet_tpu_torch/csrc/photo_loss.cu",
            replaces=replaces, photo_route="vector",
            launches=record["train_path"]["launches"][k],
            launches_by_path={name: record[key]["launches"][k]
                              for key, name in PHOTO_PATHS.items()},
            max_abs_err=max(flag[0]["vector"][k], fisheye[0]["vector"][k]),
            ms=min(t["ms"]["vector"]), ms_readings=t["ms"]["vector"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=None,
            fisheye_ms=min(tf["ms"]["vector"]),
            fisheye_ms_readings=tf["ms"]["vector"],
            fisheye_plain_ms=tf["plain_ms"],
            fisheye_bound_ms=tf["bound_ms"], fisheye_bound_by=tf["bound_by"],
            fp32_instr_per_elem=fp32[tag],
            issue_floor_ms=floor["flagship"],
            fisheye_issue_floor_ms=floor["fisheye"],
            sm_clock_mhz=clock_mhz, sm_max_clock_mhz=max_mhz,
            ptxas=record["photo_sass"][f"photo_loss_{vec}_kernel<3>"]["ptxas"],
            occupancy=occ[tag], host_ms=t["host_ms"],
            routes=dict(narrow=dict(
                launches=record["train_path"]["routes"][k]["narrow"],
                max_abs_err=max(flag[0]["narrow"][k],
                                fisheye[0]["narrow"][k]),
                ms=min(t["ms"]["narrow"]), ms_readings=t["ms"]["narrow"],
                fisheye_ms=min(tf["ms"]["narrow"]),
                fisheye_ms_readings=tf["ms"]["narrow"],
                ptxas=record["photo_sass"][f"photo_loss_{tag}_kernel"][
                    "ptxas"])),
            note=("ms, plain_ms, bound_ms: the launches of one bs12 @192x640 "
                  "step (" + ("the warped stack N=96 and the identity stack "
                              "N=24" if tag == "fwd" else "the warped stack "
                              "N=96") + " against 12 targets), float32, on "
                  "the vector route (the main path's), the least of two "
                  "readings taken in turns with the narrow route (routes."
                  "narrow: the same launches forced onto the narrow "
                  "route); fisheye_*: the same at bs16 @384x384 (N=128"
                  + (" and 32" if tag == "fwd" else "") + " against 16); "
                  "issue_floor_ms: fp32_instr_per_elem (from this run's "
                  "SASS) over 128 lanes per SM at sm_max_clock_mhz; "
                  "host_ms: the host's time to issue one call of the "
                  "public wrapper and of the narrow launcher; launches: 3 "
                  "steps of the depth-direct path (phase 9), "
                  "launches_by_path: 3 steps of each path")))
    for e in kernels:
        n = e["routes"]["narrow"]
        print(f"time  {e['name']:15s} vector {e['ms']:.4f} ms "
              f"{e['ms_readings']} (narrow {n['ms']:.4f} {n['ms_readings']})"
              f"  plain {e['plain_ms']:.4f} ms  bound {e['bound_ms']:.4f} ms "
              f"({e['bound_by']})  issue floor {e['issue_floor_ms']:.4f} ms "
              f"({e['fp32_instr_per_elem']:.2f} FP32 a pixel-channel at "
              f"{e['sm_max_clock_mhz']:.0f} MHz; SM clock read "
              f"{e['sm_clock_mhz']:.0f}); fisheye vector "
              f"{e['fisheye_ms']:.4f} ms {e['fisheye_ms_readings']} (narrow "
              f"{n['fisheye_ms']:.4f} {n['fisheye_ms_readings']})  plain "
              f"{e['fisheye_plain_ms']:.4f} ms  bound "
              f"{e['fisheye_bound_ms']:.4f} ms  issue floor "
              f"{e['fisheye_issue_floor_ms']:.4f} ms  library none; host "
              f"ms per call: wrapper {e['host_ms']['wrapper']:.4f}, narrow "
              f"launcher {e['host_ms']['narrow_launcher']:.4f}")
    return kernels


def capture_warp(model):
    """Phases 27 and 29: keeps, at every step, what the head's warp gave
    the loss (the warped stack [S, F, B, H, W, C] and the full-resolution
    depths [S, B, H, W, 1], detached) by wrapping ``_warp_all`` on the
    instance; no launch is added. Returns the record and a function that
    takes the wrap away."""
    head = model.head
    orig = head._warp_all
    seen = {}

    def wrapped(input_dict, output_dict):
        preds, overlap, depths = orig(input_dict, output_dict)
        seen.update(preds=preds.detach(), depths=depths.detach())
        return preds, overlap, depths

    head._warp_all = wrapped
    return seen, lambda: delattr(head, "_warp_all")


# profiler windows that came back holding no device event at all
EMPTY_PROFILES = []


def cuda_kernels(fn, calls=1, tries=3):
    """The CUDA kernels ``torch.profiler`` sees over ``calls`` calls of
    ``fn`` (its ``key_averages``: name, count, device time), the device
    activity alone traced: recording the host's operators too took a
    window of 3 bf16 flagship steps from 1.9 to 5.8 s and read the same
    device time (25.90 against 25.94 ms a step). The profiler has returned
    a window with no device event at all for work that launched kernels
    (phase 28, once); such a window is profiled again, up to ``tries``
    times, and counted in ``EMPTY_PROFILES``."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            return events
        EMPTY_PROFILES.append(getattr(fn, "__name__", repr(fn)))
    return events


CONV_KERNEL = re.compile(r"(conv3x3_mma_kernel|conv3x3_dw_kernel)<([^>]*)>")


def conv_kernel_args(B, shapes):
    """Phase 28: at each shape of ``shapes`` with Co = 1 or 64, the template
    arguments of the kernel each conv wrapper launches (forward, input and
    weight cotangent), by name: ``<T, TN, MODE, VEC>`` and ``<CI_T, CO_T,
    VEC>``. At Co = 1 no route may take 16-byte copies (VEC false)."""
    from fsnet_tpu_torch.ops import conv3x3 as tc

    out = {}
    for i, (name, H, W, Cs, Co, pad) in enumerate(shapes):
        if Co not in (1, 64):
            continue
        parts, w, b = conv_inputs(B, H, W, Cs, Co, torch.float32, seed=i)
        gy = torch.randn(B, H, W, Co, device="cuda")
        got = {}
        for k, fn in (("conv3x3", lambda: tc.conv3x3(parts, w, b, pad)),
                      ("conv3x3_dx", lambda: tc.conv3x3_dx(gy, w, pad, Cs)),
                      ("conv3x3_dw", lambda: tc.conv3x3_dw(parts, gy, pad))):
            names = [m.groups() for m in (CONV_KERNEL.search(e.key)
                                          for e in cuda_kernels(fn)) if m]
            check(len(names) == 1, f"{name} {k}: conv kernels launched "
                  f"{names}, expected one")
            got[k] = names[0][1]
            if Co == 1:
                check(got[k].endswith("false"), f"{name} {k} at Co = 1 took "
                      f"16-byte copies: <{got[k]}>")
        out[name] = got
        print(f"kernels {name:17s} B{B} {H}x{W} {Cs[0]}->{Co}: "
              + "  ".join(f"{k[8:] or 'fwd'} <{v}>" for k, v in got.items()))
    return out


def path_sums(rows, kernel, names):
    """Phase 31: ``kernel``'s time, plain time and library time (at the
    one-part zero-padded shapes) summed over the shape rows ``names`` (one
    per launch of a step, repeated where a step launches a shape twice),
    with the bounds of the summed work."""
    by = {r["name"]: r for r in rows}
    items = [by[n] for n in names]
    ops = sum(r[f"{kernel}_work"][0] for r in items)
    nbytes = sum(r[f"{kernel}_work"][1] for r in items)
    lib = [r for r in items if f"{kernel}_library_ms" in r]
    b_ms, b_by = ms_bound(ops, nbytes)
    tc_ms, tc_by = tc_bound(ops, nbytes)
    return dict(launches=len(items),
                ms=sum(r[f"{kernel}_ms"] for r in items),
                plain_ms=sum(r[f"{kernel}_plain_ms"] for r in items),
                bound_ms=b_ms, bound_by=b_by, tc_bound_ms=tc_ms,
                tc_bound_by=tc_by,
                library_ms=(sum(r[f"{kernel}_library_ms"] for r in lib)
                            if lib else None),
                library_shapes=[r["name"] for r in lib],
                ms_library_shapes=sum(r[f"{kernel}_ms"] for r in lib))


def nusc_conv_sums(rows, conv_errs, record):
    """Phase 31: each conv kernel's readings at the nuScenes shapes for the
    kernel line: its max abs error over every distinct shape (phase 28) and
    its times summed over one step's launches of each path (``rows``: the
    shapes' timings); the sums must count the launches phases 27 and 29
    saw."""
    up = [n for n, *_ in NUSC_SHAPES if n.startswith("upconv_")]
    d64 = [n.replace("dispconv_", "dispconv64_") for n, *_ in NUSC_SHAPES
           if n.startswith("dispconv_")]
    d16 = [n.replace("dispconv_", "dispconv16_") for n, *_ in DISTILL_SHAPES
           if n.startswith("dispconv_")]
    unc = [n for n, *_ in DISTILL_SHAPES if n.startswith("uncertain_")]
    paths = dict(
        nusc=dict(conv3x3=d64, conv3x3_bn=up, conv3x3_dx=up + d64,
                  conv3x3_dw=up + d64),
        distill=dict(conv3x3=d16 + unc + up + d16, conv3x3_bn=up,
                     conv3x3_dx=up + d16 + unc, conv3x3_dw=up + d16 + unc))
    conv = {}
    for k in ("conv3x3", "conv3x3_bn", "conv3x3_dx", "conv3x3_dw"):
        conv[k] = dict(max_abs_err=conv_errs[k], shapes=len(rows))
        if k == "conv3x3_bn":
            conv[k]["max_abs_err_moments"] = conv_errs["conv3x3_bn_mom"]
        for tag, names in paths.items():
            conv[k][f"{tag}_step"] = t = path_sums(rows, k, names[k])
            check(t["launches"] == record[f"{tag}_path"]["launches_per_step"][
                k], f"{tag} path: {k} sums {t['launches']} shapes, the step "
                f"launches {record[f'{tag}_path']['launches_per_step'][k]}")
            print(f"time  {k:11s} {tag} step ({t['launches']} launches) "
                  f"kernel {t['ms']:.4f} ms  plain {t['plain_ms']:.4f} ms  "
                  f"bound f32 {t['bound_ms']:.4f} ms ({t['bound_by']}), "
                  f"3xTF32 {t['tc_bound_ms']:.4f} ms  library "
                  + ("none" if t["library_ms"] is None else
                     f"{t['library_ms']:.4f} ms vs kernel "
                     f"{t['ms_library_shapes']:.4f} ms at "
                     f"{len(t['library_shapes'])} shapes"))
    return conv


def nusc_phases(counters, record):
    """Phases 27-31. Returns the launch counts of the two nuScenes paths
    and the readings the kernel line takes from these phases."""
    from fsnet_tpu_torch.entry import (NUSC_RECIPE, distill_config,
                                       distill_model, flagship_model,
                                       nusc_model, recipe_optimizer)
    from fsnet_tpu_torch.ops import warp_fast as twf
    from fsnet_tpu_torch.runtime.checkpoint import transform_teacher_params
    from fsnet_tpu_torch.runtime.state import make_train_step

    B, H, W = NUSC_BATCH, NUSC_H, NUSC_W
    size = f"bs{B}@{H}x{W}"
    batch = nusc_batch_np()
    sources = torch.cat([torch.from_numpy(batch[f"original_image/{f}"])
                         for f in (1, -1)]).cuda().contiguous()
    target = torch.from_numpy(batch["original_image/0"]).cuda()
    none = dict.fromkeys(counters, 0)
    photo = dict(photo_loss_fwd=2, photo_loss_bwd=1)

    def routes_taken(rec, what, mask_warps):
        got = rec["routes"]
        n = rec["steps"]
        want = dict(warp_grid_fused=dict(narrow=0, row=n),
                    warp_grid_fwd=dict(narrow=0, vector=0,
                                       row=n * mask_warps),
                    photo_loss_fwd=dict(narrow=0, vector=2 * n),
                    photo_loss_bwd=dict(narrow=0, vector=n))
        bad = {k: got[k] for k, v in want.items() if got[k] != v}
        check(not bad, f"{what}: routes {bad}, expected {want}")

    def own_moves(seen, what):
        """The TPU lane-window clamp on the step's own depths: the grids of
        the last step's depths through the batch's poses."""
        depth = seen["depths"].reshape(S_SCALES * B, H, W)
        grid = grid_scene(batch, sources, depth)[2]
        x = twf.unnormalize(grid[..., 0], W)
        out = dict(photometric=lane_window_moves(x, W),
                   mask=lane_window_moves(x, W, nearest=True),
                   samples=x.numel(), depth_min=float(depth.min()),
                   depth_max=float(depth.max()))
        print(f"{what}: on the last step's own depths (in "
              f"[{out['depth_min']:.3f}, {out['depth_max']:.3f}] m) the TPU "
              f"lane-window clamp would move {out['photometric']} "
              f"(photometric) and {out['mask']} (mask) of {out['samples']} "
              f"samples at W = {W}")
        return out

    # 27. the nusc_wpose step: ResNet-34, 64 bins, base_fx 369, no overlap
    # mask; the patched mask sends the loss down the grid route
    model = nusc_model(H, W, device="cuda", seed=0)
    opt, _ = recipe_optimizer(model, NUSC_RECIPE)
    want = dict(none, conv3x3=4, conv3x3_bn=10,
                conv3x3_dx=len(NUSC_SHAPES), conv3x3_dw=len(NUSC_SHAPES),
                warp_grid_fused=1, **photo)
    seen, release = capture_warp(model)
    rec = drive_steps(model, opt, batch, counters, want, "nuscenes path",
                      size=size)
    release()
    routes_taken(rec, "nuscenes path", 0)
    print("nuscenes path: overlapped_mask=False leaves out the mask's warp "
          "(kernel E 0 launches a step; 1 with the overlap mask)")
    rec["lane_window_moves"] = own_moves(seen, "nuscenes path")
    record["nusc_path"] = rec

    # 28. the conv kernels at every distinct conv shape of the two steps
    # (phase 8's gates, REPEATS launches each), the kernels the wrappers
    # take at Co = 1 and 64, and kernels I and J against their plain
    # versions on the step's own operands: its warped stack (kernel F's
    # output) and its sources. Autograd of the plain forward is a reading
    # here: on these operands the plain cotangent itself (to which J is
    # bitwise equal) and float32 autograd round apart by 1.09e-5 of the
    # largest entry at the first seed, as at the flagship's seeds 12-14
    # (phase 22; ROADMAP C)
    rows = [dict(name=n) for n, *_ in NUSC_CONV_SHAPES]
    record["nusc_conv_errs"] = conv_errs = check_conv_kernels(
        B, NUSC_CONV_SHAPES, rows, tag="nuscenes", forward=True)
    record["nusc_conv_kernels"] = conv_kernel_args(B, NUSC_CONV_SHAPES)
    photo_res = check_photo_kernels(
        f"nuscenes {size}", dict(warped=seen["preds"].reshape(-1, H, W, 3),
                                 identity=sources), target, seed=13,
        autograd_gate=False)
    del seen
    record["nusc_photo_ties"] = photo_res[1]
    record["nusc_photo_bwd_errs"] = photo_res[3]

    # 29. the distillation step: a frozen ResNet-18/16-bin teacher grafted
    # from a seeded MonoDepthWPose, the uncertain student
    src = flagship_model(H, W, device="cuda", seed=1).state_dict()
    dmodel = distill_model(H, W, device="cuda", seed=0, teacher_state=src)
    state = dmodel.state_dict()
    graft = transform_teacher_params(src)
    teacher_keys = [k for k in state if k.startswith("teacher_net.")]
    check(len(graft) == len(teacher_keys)
          and all(torch.equal(state["teacher_net." + k], v)
                  for k, v in graft.items()),
          "distillation: the teacher is not the grafted MonoDepthWPose")
    del src, graft, state
    dopt, _ = recipe_optimizer(dmodel, NUSC_RECIPE, distill_config(H, W))
    n_teacher = sum(n.startswith("teacher_net.")
                    for n, _ in dmodel.named_parameters())
    check(len(dopt.params) + n_teacher == len(list(dmodel.parameters())),
          "distillation: the optimizer holds teacher parameters")
    want_d = dict(none, conv3x3=4 + 4 + len(SHAPES), conv3x3_bn=10,
                  conv3x3_dx=len(DISTILL_SHAPES),
                  conv3x3_dw=len(DISTILL_SHAPES), warp_grid_fused=1,
                  warp_grid_fwd=1, **photo)
    seen, release = capture_warp(dmodel)
    drec = drive_steps(dmodel, dopt, batch, counters, want_d,
                       "distillation path", size=size, frozen="teacher_net.")
    release()
    routes_taken(drec, "distillation path", 1)
    terms = {k: v for k, v in drec["last_terms"].items()
             if k.startswith("distilation/")}
    check(sorted(terms) == [f"distilation/{s}" for s in range(4)],
          f"distillation path: loss terms {sorted(terms)}")
    print(f"distillation path: teacher ({drec['frozen_bitwise']} tensors: "
          f"{n_teacher} parameters and its BN statistics) bitwise unchanged "
          f"after {drec['steps']} steps, {drec['params_changed']} of the "
          f"student's {drec['params']} parameters moved; last step's terms "
          f"{terms}")
    drec["lane_window_moves"] = own_moves(seen, "distillation path")
    del seen
    record["distill_path"] = drec

    # 30. one step of each at bs2 on the card against the port on the CPU
    small = white_noise_images({k: v[:2] for k, v in batch.items()})
    record["nusc_card_vs_cpu"] = card_vs_cpu(
        nusc_model, small, "nuscenes train step", H, W,
        optimizer=lambda m: recipe_optimizer(m, NUSC_RECIPE))
    src = flagship_model(H, W, device="cpu", seed=1).state_dict()
    record["distill_card_vs_cpu"] = card_vs_cpu(
        lambda h, w, device, seed: distill_model(
            h, w, device=device, seed=seed, teacher_state=src),
        small, "distillation train step", H, W,
        optimizer=lambda m: recipe_optimizer(m, NUSC_RECIPE,
                                             distill_config(H, W)))
    del src

    # 31. timings: both steps (10 steps after warm-up, the batch on the
    # card; device time under the profiler), then each conv kernel at the
    # nuScenes shapes
    step = make_train_step("cuda")
    on_card = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    n_steps = 10
    for key, m, o in (("nusc_step", model, opt),
                      ("distill_step", dmodel, dopt)):
        for _ in range(2):
            step(m, o, on_card)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step(m, o, on_card)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / n_steps * 1e3
        peak = torch.cuda.max_memory_allocated() / 1e9
        busy = sum(e.self_device_time_total for e in cuda_kernels(
            lambda: step(m, o, on_card), calls=3)) / 1e3 / 3
        check(busy > 0, f"{key}: the profiler saw no device time")
        record[key] = dict(bs=B, ms=ms, imgs_per_s=B / ms * 1e3,
                           device_busy_ms=busy, peak_mem_gb=peak)
        print(f"{key} {size} f32 (mean of {n_steps}, batch on the card): "
              f"{ms:.3f} ms = {B / ms * 1e3:.2f} imgs/s; device busy "
              f"{busy:.3f} ms a step (profiler, 3 steps); peak memory "
              f"{peak:.3f} GB")
    del model, opt, dmodel, dopt, on_card
    time_conv_kernels(B, NUSC_CONV_SHAPES, rows, forward=True)
    record["nusc_conv_shapes"] = [
        {k: v for k, v in r.items() if not k.endswith("_work")}
        for r in rows]
    conv = nusc_conv_sums(rows, conv_errs, record)
    ph = {}
    for tag, k in (("fwd", "photo_loss_fwd"), ("bwd", "photo_loss_bwd")):
        t = photo_res[2][tag]
        ph[k] = dict(max_abs_err=photo_res[0]["vector"][k],
                     autograd_rel_err=[e["autograd"] for e in
                                       photo_res[3]["vector"]]
                     if tag == "bwd" else None,
                     ms=min(t["ms"]["vector"]), ms_readings=t["ms"]["vector"],
                     narrow_ms=min(t["ms"]["narrow"]),
                     plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                     bound_by=t["bound_by"])
    return dict(launches=dict(nusc=rec["launches"],
                              distill=drec["launches"]),
                conv=conv, photo=ph)


def add_nusc_readings(kernels, nusc):
    """Phases 27-31 into the kernel line: every kernel's launches on the two
    nuScenes paths (3 steps each), the conv kernels' errors at the
    nuScenes shapes and their times summed over each step's launches, and
    kernels I and J on the nuScenes step's operands."""
    for e in kernels:
        k = e["name"]
        for tag in ("nusc", "distill"):
            e[f"launches_{tag}_path"] = nusc["launches"][tag][k]
        extra = nusc["conv"].get(k) or nusc["photo"].get(k)
        if extra:
            e["nuscenes"] = extra
            e["note"] = e.get("note", "") + (
                "; nuscenes: phases 27-31 at bs8 @288x512 (max_abs_err over "
                "every distinct conv shape of both steps; *_step: sums over "
                "one step's launches)" if k.startswith("conv") else
                "; nuscenes: the nuscenes step's warped stack and sources "
                "at bs8 @288x512, vector route (phase 28)")



# ---------------------------------------------------------------- bf16 step

BF16 = torch.bfloat16


def bf16_ulp(t):
    """One bfloat16 ulp at |t| elementwise (0 at 0)."""
    a = t.float().abs()
    e = torch.frexp(a).exponent
    return torch.where(a > 0, torch.ldexp(torch.ones_like(a), e - 8),
                       torch.zeros_like(a))


class HeldUlp(Held):
    """A bfloat16 output of a conv kernel held over repeated launches: each
    launch within one bf16 ulp of the plain ``ref`` elementwise beyond
    ``gate`` times max |ref| (the two round float32 sums taken in other
    orders: the float32 gate), and bitwise equal to the first launch. A
    miss is saved as :class:`Held` saves one."""

    share = 0.0

    def __call__(self, got):
        self.n += 1
        diff = (got.float() - self.ref.float()).abs()
        big = torch.maximum(got.float().abs(), self.ref.float().abs())
        nbad = int((diff > bf16_ulp(big) + self.gate * self.den).sum())
        d = diff.max().item()
        self.d, self.e = max(self.d, d), max(self.e, d / self.den)
        self.share = max(self.share, float((got != self.ref).double().mean()))
        if self.first is None:
            self.first = got
        same = torch.equal(got, self.first)
        if nbad or not same:
            what = (f"launch {self.n}: {nbad} elements beyond one bf16 ulp + "
                    f"{self.gate:.0e} of max |plain|"
                    + ("" if same else ", not bitwise equal to launch 1"))
            save_fault(f"{self.tag}_launch{self.n}", what, self.inputs, got,
                       self.first, self.ref, self.ref64(),
                       self.gate * self.den)
            check(False, f"{self.tag}: {what}")


def template_name(mangled):
    """``conv3x3_dw_kernel<bf16, 16, 32, true>`` from a mangled kernel
    name whose template arguments are types (float, bfloat16), ints and
    bools."""
    name = kernel_name(mangled)
    return mangled if name is None else name.replace(",", ", ")


def bf16_ptxas(logs):
    """ptxas's register, spill and shared-memory lines of every kernel
    instantiated on bfloat16 operands, by name, from the build's
    ``-Xptxas -v`` messages."""
    out = {}
    for lib, log in logs.items():
        name = None
        for line in log.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?(\w+)", line)
            if m:
                name = (template_name(m.group(1))
                        if "nv_bfloat16" in m.group(1) else None)
            elif name and ("registers" in line or "spill" in line):
                out.setdefault(f"{lib}: {name}", []).append(
                    line.split(":", 1)[-1].strip())
    return out


def check_bf16_kernels(train, record):
    """Phase 32: each bfloat16 form against its plain version on the card,
    each launched :data:`REPEATS` times: the moments kernel at the 10
    upconv shapes and the weight cotangent at all 14 of the bs12 train step
    (phase 8's trap saves a miss), kernels I and J on the depth-direct
    step's warped and identity stacks at bf16, and the warps A, B, F and
    E (at the mask) through their wrappers on bf16 images. Prints each
    bf16 kernel's ptxas report and the photometric kernels' occupancy.
    Returns the max abs errors by kernel and the operands phase 35
    times."""
    from fsnet_tpu_torch.ops import conv3x3 as tc
    from fsnet_tpu_torch.ops import photo_loss as tpl
    from fsnet_tpu_torch.ops import warp_depth as twd
    from fsnet_tpu_torch.ops import warp_fast as twf
    from fsnet_tpu_torch.ops.ssim import ssim_target_stats

    for name, lines in record["bf16_ptxas"].items():
        for line in lines:
            print(f"  ptxas bf16 {name}: {line}")
    occ = record["bf16_photo_occupancy"] = photo_occupancy(1)
    print(f"photometric vector kernels at bf16, C = 3: {occ} (float32 "
          f"tiles, as the float32 kernels': {record['photo_occupancy']})")

    errs = dict(conv3x3_bn=0.0, conv3x3_bn_mom=0.0, conv3x3_dw=0.0)
    shares = []
    for i, (name, H, W, Cs, Co, pad) in enumerate(SHAPES):
        parts, w, b = conv_inputs(BATCH, H, W, Cs, Co, BF16, seed=i)
        gy = torch.randn(BATCH, H, W, Co, device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(100 + i)).to(BF16)
        inputs = {f"x{j}": p for j, p in enumerate(parts)}
        inputs.update(w=w, b=b, gy=gy)
        at = f"bf16_{name}"

        def conv64():
            return tc._conv_core([p.double() for p in parts], w.double(),
                                 b.double(), pad)

        held = {}
        bn = name.startswith("upconv_")
        if bn:
            ref = tc.conv3x3_plain(parts, w, b, pad)
            r1, r2 = tc.moments_plain(ref)
            held["bn"] = HeldUlp(f"{at}_bn_out", ref, 2e-5, True, inputs,
                                 conv64)
            s1_scale = ref.float().abs().sum((0, 1, 2)).max().item()
            mom = dict(s1=0.0, s2=0.0, plain_s1=0.0, plain_s2=0.0)
            del ref
        held["dw"] = Held(f"{at}_dw", tc.conv3x3_dw_plain(parts, gy, pad),
                          2e-5, False, inputs,
                          lambda: tc.conv3x3_dw_plain(
                              [p.double() for p in parts], gy.double(), pad))
        for _ in range(REPEATS):
            got = {}
            if bn:
                got["bn"], got["s1"], got["s2"] = tc.conv3x3_bn(parts, w, b,
                                                                pad)
            got["dw"] = tc.conv3x3_dw(parts, gy, pad)
            torch.cuda.synchronize()
            check(got["dw"].dtype == torch.float32 and (
                not bn or (got["bn"].dtype == BF16
                           and got["s1"].dtype == torch.float32)),
                  f"{at}: output dtypes")
            for k, v in got.items():
                if k in held:
                    held[k](v)
            if bn:
                # the moments: float32 sums of this launch's own stored
                # output, at phase 8's gates; beside the plain moments (of
                # the plain output, whose bf16 rounding may differ by one
                # ulp in some elements: a reading)
                own = tc.moments_plain(got["bn"])
                for k, r, pr, scale in (("s1", own[0], r1, s1_scale),
                                        ("s2", own[1], r2, None)):
                    Held(f"{at}_bn_{k}", r, 2e-5, False, inputs,
                         lambda k=k: tc.moments_plain(
                             got["bn"].double())[k == "s2"],
                         scale)(got[k])
                    e = rel_err(got[k], r, scale)[1]
                    mom[k] = max(mom[k], e)
                    mom[f"plain_{k}"] = max(mom[f"plain_{k}"], rel_err(
                        got[k], pr, scale)[1])
                    errs["conv3x3_bn_mom"] = max(errs["conv3x3_bn_mom"],
                                                 rel_err(got[k], r)[0])
        errs["conv3x3_dw"] = max(errs["conv3x3_dw"], held["dw"].d)
        line = f"dw {held['dw'].e:.2e}"
        if bn:
            errs["conv3x3_bn"] = max(errs["conv3x3_bn"], held["bn"].d)
            shares.append(held["bn"].share)
            line = (f"bn out max abs err {held['bn'].d:.2e} "
                    f"({held['bn'].share:.2e} not bitwise equal, all within "
                    f"one bf16 ulp) s1 {mom['s1']:.2e} s2 {mom['s2']:.2e} "
                    f"(of the launch's own output; of the plain output "
                    f"{mom['plain_s1']:.2e}, {mom['plain_s2']:.2e}) " + line)
        print(f"check bf16 {name:11s} B{BATCH} {H}x{W} x{REPEATS}: rel err "
              f"{line}")
    record["bf16_conv_bn_not_bitwise"] = max(shares)

    # kernels I and J on the depth-direct step's stacks at bf16
    wi = train["warp_in"]
    image = wi["image"].to(BF16)
    depth, arows = wi["depth"], wi["arows"]
    warped, ov, va, vb = twd.warp_depth_fwd(image, depth, arows, S_SCALES,
                                            F_FRAMES, BAND)
    target = torch.from_numpy(
        train["batch"]["original_image/0"]).cuda().to(BF16)
    muy, sy = ssim_target_stats(target)
    for kind, pred in (("warped", warped), ("identity", image)):
        check(tpl.photo_route(pred, target, muy, sy) == "vector",
              f"bf16 {kind} stack: operands miss the vector route")
        ref = tpl.photo_loss_plain(pred, target, muy, sy)
        for _ in range(REPEATS):
            got = tpl.photo_loss_fwd(pred, target, muy, sy)
            torch.cuda.synchronize()
            check(got.dtype == BF16 and torch.equal(got, ref),
                  f"photo_loss_fwd bf16 {kind}: not bitwise equal to the "
                  "plain version")
    errs["photo_loss_fwd"] = 0.0
    N = warped.shape[0]
    g = torch.randn(N, HEIGHT, WIDTH, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(13)
                    ).to(BF16)
    ref = tpl.photo_loss_bwd_plain(warped, target, muy, sy, g)
    wide = [t.float() for t in (warped, target, muy, sy, g)]
    ref32 = tpl.photo_loss_bwd_plain(*wide)
    for _ in range(REPEATS):
        dx = tpl.photo_loss_bwd(warped, target, muy, sy, g)
        dx32 = tpl.photo_loss_bwd(*wide)
        torch.cuda.synchronize()
        e32 = rel_err(dx32, ref32)[1]
        check(dx.dtype == BF16 and torch.equal(dx, ref)
              and torch.equal(dx, dx32.to(BF16)) and e32 <= 1e-5,
              f"photo_loss_bwd bf16: not bitwise equal to the plain version "
              f"or to its float32 form rounded, or the float32 form "
              f"{e32:.2e} > 1e-5 of the largest entry")
    errs["photo_loss_bwd"] = 0.0
    print(f"check bf16 photometric loss, warped N={N} and identity stacks "
          f"{HEIGHT}x{WIDTH}x3 against B={BATCH} (vector route) x{REPEATS}: "
          f"I bitwise equal to the plain version on both; J bitwise equal "
          f"to the plain version and to its float32 form on the widened "
          f"operands, rounded; that float32 form {e32:.2e} of the largest "
          f"entry from the float32 plain cotangent")

    # the warps A, B (depth-direct) and F, E (grid route) at bf16
    ref = twd.warp_depth_plain(image.float(), depth, arows, S_SCALES,
                               F_FRAMES, BAND)
    ref = (ref[0].to(BF16), ref[1], ref[2].to(BF16), ref[3].to(BF16))
    gb = torch.randn(warped.shape, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(7)
                     ).to(BF16)
    dd_ref = twd.warp_depth_bwd_plain(depth, gb, ref[2], ref[3], arows,
                                      S_SCALES, F_FRAMES)
    e_dd = 0.0
    for _ in range(REPEATS):
        got = twd.warp_depth_fwd(image, depth, arows, S_SCALES, F_FRAMES,
                                 BAND)
        dd = twd.warp_depth_bwd(depth, gb, got[2], got[3], arows, S_SCALES,
                                F_FRAMES)
        torch.cuda.synchronize()
        check(all(torch.equal(a, r) for a, r in zip(got, ref)),
              "kernel A at bf16: not bitwise equal to the plain version")
        e_dd = max(e_dd, rel_err(dd, dd_ref)[1])
        check(dd.dtype == torch.float32 and e_dd <= 1e-6,
              f"kernel B at bf16: rel err {e_dd:.2e} > 1e-6")
    errs["warp_depth_fwd"], errs["warp_depth_bwd"] = 0.0, e_dd
    image_g, mask, grid = grid_scene(train["batch"], wi["image"], depth)
    image_g, mask = image_g.to(BF16), mask.to(BF16)
    ref_f = tuple(t.to(BF16) for t in twf.grid_band_plain(
        image_g.float(), grid, "bilinear", "border", BAND))
    ref_e = twf.grid_band_plain(mask.float(), grid, "nearest", "zeros", BAND,
                                False)[0].to(BF16)
    for _ in range(REPEATS):
        got = twf.grid_band_fused(image_g, grid, "border", BAND)
        ov = twf.grid_band_fwd(mask, grid, "nearest", "zeros", BAND)
        torch.cuda.synchronize()
        check(all(torch.equal(a, r) for a, r in zip(got, ref_f))
              and torch.equal(ov, ref_e),
              "kernels F, E at bf16: not bitwise equal to the plain versions")
    errs["warp_grid_fused"] = errs["warp_grid_fwd"] = 0.0
    print(f"check bf16 warps x{REPEATS}: A (out, overlap, va, vb) bitwise "
          f"equal to the plain version, B (its bf16 form: bf16 loads, gfx "
          f"and gfy formed in the kernel) rel err {e_dd:.2e} (gate 1e-6), "
          f"F (out, va, vb) and E (the mask) bitwise; A, F and E on their "
          f"float32 kernels, the image widened at the wrapper and out, va, "
          f"vb rounded to bf16")
    return errs, dict(image=image, depth=depth, arows=arows, warped=warped,
                      va=va, vb=vb, gb=gb, target=target, muy=muy, sy=sy,
                      g=g, grid_scene=(image_g, mask, grid))


def bf16_steps(counters, record, train):
    """Phase 33: one bf16 step of each route of the flagship (depth-direct
    on the synthetic batch, the grid route with an all-ones patched mask)
    through ``make_train_step(compute_dtype=...)`` with the recipe's
    compute dtype, the launch counters set to 0 just before: the launches
    per kernel as at float32, the conv and photometric kernels on bf16
    operands (by the wrappers' dtype counts), the warps' on their float32
    kernels, the routes as at float32, the warped frames the loss saw
    bf16; the lane-window count on the step's own depths."""
    from fsnet_tpu_torch.entry import (FLAGSHIP_RECIPE, flagship_model,
                                       flagship_optimizer)
    from fsnet_tpu_torch.ops import warp_depth as twd
    from fsnet_tpu_torch.ops import warp_fast as twf
    from fsnet_tpu_torch.ops.geometry import project_rows
    from fsnet_tpu_torch.runtime.state import make_train_step

    cdt = FLAGSHIP_RECIPE["compute_dtype"]
    step = make_train_step("cuda", compute_dtype=cdt)
    bf16_kernels = ("conv3x3", "conv3x3_bn", "conv3x3_dx", "conv3x3_dw",
                    "photo_loss_fwd", "photo_loss_bwd", "warp_depth_bwd")
    out = {}
    want_dd = train["want"]
    want_grid = dict(want_dd, warp_depth_fwd=0, warp_depth_bwd=0,
                     warp_grid_fused=1, warp_grid_fwd=1)
    batches = dict(depth_direct=train["batch"], grid=flagship_masked_np())
    for route, want in (("depth_direct", want_dd), ("grid", want_grid)):
        model = flagship_model(HEIGHT, WIDTH, device="cuda", seed=0)
        opt, _ = flagship_optimizer(model)
        p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        seen, release = capture_warp(model)
        zero(counters)
        met = step(model, opt, batches[route])
        torch.cuda.synchronize()
        counts = read(counters)
        dtypes = {k: dict(counters[k].dtypes) for k in bf16_kernels}
        rts = routes(counters)
        release()
        loss = float(met["loss"])
        check(np.isfinite(loss), f"bf16 {route} step: loss {loss}")
        check(counts == want, f"bf16 {route} step: launches {counts}, "
              f"expected {want}")
        check(all(dtypes[k] == dict(float32=0, bfloat16=want[k])
                  for k in bf16_kernels),
              f"bf16 {route} step: launches by dtype {dtypes}")
        check(seen["preds"].dtype == BF16, f"bf16 {route} step: the loss "
              f"saw {seen['preds'].dtype} warped frames")
        wanted_routes = dict(photo_loss_fwd=dict(narrow=0, vector=2),
                             photo_loss_bwd=dict(narrow=0, vector=1))
        if route == "depth_direct":
            wanted_routes["warp_depth_fwd"] = dict(narrow=0, vector=1)
        else:
            wanted_routes["warp_grid_fused"] = dict(narrow=0, row=1)
            wanted_routes["warp_grid_fwd"] = dict(narrow=0, vector=0, row=1)
        for k, r in wanted_routes.items():
            check(rts[k] == r, f"bf16 {route} step: {k} routes {rts[k]}, "
                  f"expected {r}")
        moved = sum(int(not torch.equal(p.detach(), p0[n]))
                    for n, p in model.named_parameters())
        check(moved >= len(p0) - 10, f"bf16 {route} step: {moved} of "
              f"{len(p0)} parameters moved")
        # the lane-window clamp on this step's own depths
        depth = seen["depths"].reshape(S_SCALES * BATCH, HEIGHT, WIDTH)
        if route == "depth_direct":
            x = project_rows(twd._per_warp_depth(depth, S_SCALES, F_FRAMES),
                             train["warp_in"]["arows"])["x"]
        else:
            grid = grid_scene(batches[route], train["warp_in"]["image"],
                              depth)[2]
            x = twf.unnormalize(grid[..., 0], WIDTH)
        lane = lane_window_moves(x, WIDTH)
        out[route] = dict(loss=loss, launches=counts, dtypes=dtypes,
                          routes=rts, params_moved=moved,
                          lane_window_moves=lane, samples=x.numel(),
                          depth_min=float(depth.min()),
                          depth_max=float(depth.max()))
        print(f"bf16 {route} step bs{BATCH}@{HEIGHT}x{WIDTH} (compute_dtype "
              f"{cdt!r}): loss {loss:.6f}, launches {counts}, by dtype "
              f"{dtypes}, routes { {k: rts[k] for k in wanted_routes} }, "
              f"{moved} of {len(p0)} parameters moved; on the step's own "
              f"depths (in [{out[route]['depth_min']:.3f}, "
              f"{out[route]['depth_max']:.3f}] m) the TPU lane-window clamp "
              f"would move {lane} of {x.numel()} samples")
        del model, opt, seen
    return out, batches


def bf16_vs_cpu(build, small, what, H, W, compute_dtype, optimizer=None,
                against_control=False, reprojection=False):
    """One bf16 step of ``build(H, W, ...)`` at batch 2 on the card and
    through the port on the CPU, from the same seeded weights, on ``small``
    (smooth textures), held to the JAX package's own bf16 gates
    (``scripts/tpu_smoke.py``): loss rel < 2e-2, which the card's float32
    step (the control: a step that did not compute in bf16) must miss
    against the CPU's bf16 loss; the card's bf16 gradients against the CPU
    port's bf16 ones, global rel-L2 < 0.3 and every leaf < 0.6 without the
    BN-cancelled biases (the flagship measured 0.20 and 0.39: the two round
    apart, as two bf16 implementations do), gates that the card's float32
    gradients, the control, must miss one of (the flagship: 0.49 and
    0.94); with ``against_control`` instead below the control's own
    distances, global rel-L2 under 3/4 of the control's and the worst leaf
    under the control's worst (for deeper nets, whose two bf16 gradients
    lie further apart: ``nusc_wpose`` measured 0.48 and 0.71 beside the
    control's 0.82 and 1.18); the card's bf16 gradient against the same
    model's float32 step on the card, cosine > 0.25; every gradient leaf
    on the card equal to its own bf16 rounding. Prints the bf16/f32 loss
    ratio (not gated). With ``reprojection`` the losses compared are the
    steps' losses less their distillation terms, which would drown the
    photometric loss where bf16 and float32 part (the distillation step:
    its f32 control's total loss lies within 5.8e-3 of the bf16 one)."""
    kw = dict(optimizer=optimizer, reprojection=reprojection)
    l16, g16, _ = one_step(build, small, "cuda", H, W,
                           compute_dtype=compute_dtype, **kw)
    l16c, g16c, _ = one_step(build, small, "cpu", H, W,
                             compute_dtype=compute_dtype, **kw)
    l32, g32, _ = one_step(build, small, "cuda", H, W, **kw)
    rel = abs(l16 - l16c) / abs(l16c)
    control = abs(l32 - l16c) / abs(l16c)
    a = torch.cat([g16[k].flatten() for k in sorted(g16)])
    b = torch.cat([g32[k].flatten() for k in sorted(g32)])
    cos = float(a @ b / (a.norm() * b.norm()))
    rounded = [k for k, g in g16.items()
               if not torch.equal(g, g.to(BF16).double())]
    kept = [k for k in g16c if not bn_cancelled(k) and bool(g16c[k].any())]

    def worst_leaf(g):
        leaf = {k: float((g[k] - g16c[k]).norm() / g16c[k].norm())
                for k in kept}
        worst = max(leaf, key=leaf.get)
        return worst, leaf[worst]

    grad_rel, (leaf, leaf_rel) = grad_rel_l2(g16, g16c), worst_leaf(g16)
    c_grad_rel, (_, c_leaf_rel) = grad_rel_l2(g32, g16c), worst_leaf(g32)
    gate = ((0.75 * c_grad_rel, c_leaf_rel) if against_control
            else (0.3, 0.6))
    out = dict(loss_card=l16, loss_cpu=l16c, loss_rel=rel, grad_gates=gate,
               control_f32_loss_rel=control, grad_rel_l2=grad_rel,
               worst_leaf=leaf, worst_leaf_rel_l2=leaf_rel,
               control_f32_grad_rel_l2=c_grad_rel,
               control_f32_worst_leaf_rel_l2=c_leaf_rel,
               grad_cosine_vs_f32=cos, loss_f32=l32,
               bf16_f32_loss_ratio=l16 / l32, leaves_not_bf16=rounded)
    print(f"bf16 card vs CPU port, {what} bs2@{H}x{W}: "
          + ("loss less the distillation terms " if reprojection
             else "loss ")
          + f"{l16:.6f} vs {l16c:.6f} (rel {rel:.2e}, gate 2e-2; the "
          f"card's f32 step {l32:.6f}, rel {control:.2e}, must miss); "
          f"gradients global rel-L2 {grad_rel:.3e} (gate {gate[0]:.3g}), "
          f"worst leaf {leaf} {leaf_rel:.3e} (gate {gate[1]:.3g}); the "
          f"card's f32 gradients against the same {c_grad_rel:.3e}, "
          f"{c_leaf_rel:.3e}; gradient cosine against the card's f32 "
          f"step {cos:.4f} (gate > 0.25); bf16/f32 loss ratio "
          f"{l16 / l32:.4f} (not gated); leaves not bf16-valued: "
          f"{len(rounded)}")
    check(rel < 2e-2, f"bf16 {what}: card vs CPU loss rel {rel:.2e}")
    check(control >= 2e-2, f"bf16 {what}: the f32 control's loss rel "
          f"{control:.2e} passes the bf16 gate")
    check(grad_rel < gate[0] and leaf_rel < gate[1], f"bf16 {what}: card "
          f"vs CPU gradients rel-L2 {grad_rel:.3e}, {leaf} {leaf_rel:.3e}, "
          f"gates {gate}")
    check(against_control or c_grad_rel >= 0.3 or c_leaf_rel >= 0.6,
          f"bf16 {what}: the f32 control's gradients pass the bf16 gates: "
          f"{c_grad_rel:.3e}, {c_leaf_rel:.3e}")
    check(cos > 0.25, f"bf16 {what}: gradient cosine {cos:.4f}")
    check(not rounded, f"bf16 {what}: gradient leaves not bf16-valued: "
          f"{rounded[:5]}")
    return out


def bf16_card_vs_cpu(batches):
    """Phase 34: one bf16 step at bs2 @192x640 of each flagship route on
    the card and through the port on the CPU, on the synthetic batch's own
    images (spatially correlated textures), held to
    :func:`bf16_vs_cpu`'s gates."""
    from fsnet_tpu_torch.entry import FLAGSHIP_RECIPE, flagship_model

    return {route: bf16_vs_cpu(flagship_model,
                               {k: v[:2] for k, v in batch.items()}, route,
                               HEIGHT, WIDTH,
                               FLAGSHIP_RECIPE["compute_dtype"])
            for route, batch in batches.items()}


def time_step(build_opt, batch, cdt, what, B):
    """One train step of the model and optimizer ``build_opt()`` gives, in
    float32 (``cdt`` None) or at ``cdt``, timed as ``bench.py`` times the
    JAX step: ``batch`` on the card, 3 warm-up steps, then
    :data:`TIMING_WINDOWS` windows of 20 steps, the fastest kept;
    device-busy ms a step under ``torch.profiler`` over 3 steps; peak
    memory over the windows."""
    from fsnet_tpu_torch.runtime.state import make_train_step

    on_card = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    model, opt = build_opt()
    step = make_train_step("cuda", compute_dtype=cdt)
    for _ in range(3):
        step(model, opt, on_card)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    windows = []
    for _ in range(TIMING_WINDOWS):
        t0 = time.perf_counter()
        for _ in range(20):
            step(model, opt, on_card)
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) / 20 * 1e3)
    peak = torch.cuda.max_memory_allocated() / 1e9
    busy = sum(e.self_device_time_total for e in cuda_kernels(
        lambda: step(model, opt, on_card), calls=3)) / 1e3 / 3
    check(busy > 0, f"{what}: the profiler saw no device time")
    ms = min(windows)
    print(f"train step {what} (fastest of {TIMING_WINDOWS} windows of 20, "
          f"batch on the card): {ms:.3f} ms = {B / ms * 1e3:.2f} imgs/s, "
          f"windows {[round(w, 3) for w in windows]}; device busy "
          f"{busy:.3f} ms a step; peak memory {peak:.3f} GB")
    return dict(ms=ms, windows_ms=windows, imgs_per_s=B / ms * 1e3,
                device_busy_ms=busy, peak_mem_gb=peak)


def time_steps(batches):
    """Phase 35: the flagship step at bs12 @192x640 in float32 and in bf16
    on each route (:func:`time_step`)."""
    from fsnet_tpu_torch.entry import (FLAGSHIP_RECIPE, flagship_model,
                                       flagship_optimizer)

    def build_opt():
        model = flagship_model(HEIGHT, WIDTH, device="cuda", seed=0)
        return model, flagship_optimizer(model)[0]

    return {f"{route}_{tag}": time_step(
        build_opt, batch, cdt,
        f"{route} {tag} bs{BATCH}@{HEIGHT}x{WIDTH}", BATCH)
        for route, batch in batches.items()
        for tag, cdt in (("f32", None),
                         ("bf16", FLAGSHIP_RECIPE["compute_dtype"]))}


def time_bf16_kernels(ops_in, counts):
    """Phase 35: each kernel's bf16 form at the bs12 train step's shapes
    beside its float32 form: the conv kernels at every shape (with cuDNN
    in bf16 at the one-part zero-padded ones), the warps A, B, F and E
    through their wrappers on bf16 images (the widening and rounding passes
    included) beside their float32 kernels, and I, J on the step's bf16
    stacks beside the float32 kernels on the same values. Bounds at bf16
    bytes. Returns the kernel line's bf16 entries and the warps' bf16
    readings."""
    from fsnet_tpu_torch.ops import photo_loss as tpl
    from fsnet_tpu_torch.ops import warp_depth as twd
    from fsnet_tpu_torch.ops import warp_fast as twf

    rows = [dict(name=n) for n, *_ in SHAPES]
    tot = time_conv_kernels(BATCH, SHAPES, rows, forward=True, dtype=BF16)
    src = "fsnet_tpu_torch/csrc/"
    meta = dict(
        conv3x3=(src + "conv3x3.cu",
                 "fsnet_tpu/ops/pallas/conv_kernel.py:210"),
        conv3x3_bn=(src + "conv3x3.cu",
                    "fsnet_tpu/ops/pallas/conv_kernel.py:258"),
        conv3x3_dx=(src + "conv3x3.cu",
                    "fsnet_tpu/ops/pallas/conv_kernel.py:210"),
        conv3x3_dw=(src + "conv3x3_dw.cu",
                    "fsnet_tpu/ops/pallas/conv_kernel.py:351"),
        photo_loss_fwd=(src + "photo_loss.cu",
                        "fsnet_tpu/ops/pallas/photo_kernel.py:324"),
        photo_loss_bwd=(src + "photo_loss.cu",
                        "fsnet_tpu/ops/pallas/photo_kernel.py:370"))
    entries = []
    for k, t in tot.items():
        ops = sum(o for o, _ in t["items"])
        nbytes = sum(b for _, b in t["items"])
        b_ms, b_by = ms_bound(ops, nbytes)
        tc_ms, tc_by = tc_bound(ops, nbytes, BF16)
        t16_ms, t16_by = tc16_bound(ops, nbytes)
        entries.append(dict(
            name=k + "_bf16", form="bf16", route="cuda", source=meta[k][0],
            replaces=meta[k][1], launches=counts["depth_direct"]["dtypes"][k][
                "bfloat16"],
            launches_grid_route=counts["grid"]["dtypes"][k]["bfloat16"],
            max_abs_err=None, ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=b_ms, bound_by=b_by, tc_bound_ms=tc_ms,
            tc_bound_by=tc_by, tc16_bound_ms=t16_ms, tc16_bound_by=t16_by,
            library_ms=t["lib_ms"] if t["lib_shapes"] else None,
            library_shapes=t["lib_shapes"],
            ms_library_shapes=t["lib_kernel_ms"],
            note="bfloat16 operands: sums over the shapes of one bs12 train "
                 "step's launches (conv3x3: all 14 shapes; the step launches "
                 "it at the 4 dispconvs); bound_ms on the float32 CUDA "
                 "cores, tc_bound_ms at one TF32 product (the kernels' "
                 "route), tc16_bound_ms at the bf16 tensor-core rate, all "
                 "at bf16 bytes; library_ms: cuDNN in bf16 at "
                 "library_shapes, ms_library_shapes the kernel there"))
    record_rows = [{k: v for k, v in r.items() if not k.endswith("_work")}
                   for r in rows]

    # the photometric kernels on the step's bf16 stacks, bf16 beside f32
    o = ops_in
    stacks = dict(warped=o["warped"], identity=o["image"])
    photo = {}
    for k, fn in (("photo_loss_fwd", tpl.photo_loss_fwd),
                  ("photo_loss_bwd", tpl.photo_loss_bwd)):
        items = stacks.items() if k == "photo_loss_fwd" else [
            ("warped", o["warped"])]
        ms16 = ms32 = plain = 0.0
        ops = nbytes = 0.0
        for kind, pred in items:
            args = (pred, o["target"], o["muy"], o["sy"]) + (
                (o["g"],) if k == "photo_loss_bwd" else ())
            wide = tuple(a.float() for a in args)
            ms16 += cuda_ms(lambda: fn(*args), iters=10)
            ms32 += cuda_ms(lambda: fn(*wide), iters=10)
            plain += cuda_ms(lambda: (tpl.photo_loss_plain if k ==
                                      "photo_loss_fwd" else
                                      tpl.photo_loss_bwd_plain)(*args),
                             iters=3, warmup=1)
            N, H, W, C = pred.shape
            px = N * H * W * C
            ops += PHOTO_OPS["fwd" if k == "photo_loss_fwd" else "bwd"] * px
            nbytes += 2.0 * (px + 3 * BATCH * H * W * C + N * H * W) + (
                2.0 * (N * H * W + px) if k == "photo_loss_bwd" else 0.0)
        b_ms, b_by = ms_bound(ops, nbytes)
        photo[k] = dict(ms=ms16, f32_kernel_ms=ms32, plain_ms=plain,
                        bound_ms=b_ms, bound_by=b_by)
        entries.append(dict(
            name=k + "_bf16", form="bf16", route="cuda", source=meta[k][0],
            replaces=meta[k][1],
            launches=counts["depth_direct"]["dtypes"][k]["bfloat16"],
            launches_grid_route=counts["grid"]["dtypes"][k]["bfloat16"],
            max_abs_err=0.0, ms=ms16, plain_ms=plain, bound_ms=b_ms,
            bound_by=b_by, library_ms=None, f32_kernel_ms=ms32,
            photo_route="vector",
            note="bfloat16 operands: one bs12 step's launches on the "
                 "depth-direct step's bf16 stacks (" + (
                     "warped N=96 and identity N=24" if k ==
                     "photo_loss_fwd" else "warped N=96")
                 + "), vector route; f32_kernel_ms: the float32 kernel on "
                 "the same values; bound at bf16 bytes"))

    # the warps through their wrappers on bf16 images, beside the float32
    # kernels on the same values
    img, dep, ar = o["image"], o["depth"], o["arows"]
    N = ar.shape[0]
    px = N * HEIGHT * WIDTH
    FB, SB, C = img.shape[0], dep.shape[0], img.shape[-1]
    image_g, mask, grid = o["grid_scene"]
    warps = {
        "warp_depth_fwd": (
            lambda: twd.warp_depth_fwd(img, dep, ar, S_SCALES, F_FRAMES, BAND),
            lambda: twd.warp_depth_fwd(img.float(), dep, ar, S_SCALES,
                                       F_FRAMES, BAND),
            (px * (32.0 + 14.0 * C),
             2.0 * FB * HEIGHT * WIDTH * C + 4.0 * (SB * HEIGHT * WIDTH
                                                    + N * 16)
             + px * (3 * 2.0 * C + 1))),
        "warp_depth_bwd": (
            lambda: twd.warp_depth_bwd(dep, o["gb"], o["va"], o["vb"], ar,
                                       S_SCALES, F_FRAMES),
            lambda: twd.warp_depth_bwd(dep, o["gb32"], o["va32"],
                                       o["vb32"], ar, S_SCALES, F_FRAMES),
            (px * (40.0 + 4.0 * C),
             2.0 * 3 * px * C + 4.0 * (2 * SB * HEIGHT * WIDTH + N * 16))),
        "warp_grid_fused": (
            lambda: twf.grid_band_fused(image_g, grid, "border", BAND),
            lambda: twf.grid_band_fused(image_g.float(), grid, "border",
                                        BAND),
            (px * (20.0 + 21.0 * C),
             2.0 * image_g.numel() + 4.0 * grid.numel() + 2.0 * 3 * px * C)),
        "warp_grid_fwd": (
            lambda: twf.grid_band_fwd(mask, grid, "nearest", "zeros", BAND),
            lambda: twf.grid_band_fwd(mask.float(), grid, "nearest", "zeros",
                                      BAND),
            (px * 29.0,
             2.0 * mask.numel() + 4.0 * grid.numel() + 2.0 * px)),
    }
    readings = {}
    for k, (fn, f32, ob) in warps.items():
        b_ms, b_by = ms_bound(*ob)
        readings[k] = dict(
            ms=cuda_ms(fn, iters=10), f32_kernel_ms=cuda_ms(f32, iters=10),
            bound_ms=b_ms, bound_by=b_by,
            launches=counts["depth_direct"]["launches"][k],
            launches_grid_route=counts["grid"]["launches"][k])
    for e in entries:
        print(f"time  {e['name']:19s} {e['ms']:.4f} ms  plain "
              f"{e['plain_ms']:.4f} ms  bound {e['bound_ms']:.4f} ms "
              f"({e['bound_by']})"
              + (f"  TF32 {e['tc_bound_ms']:.4f}  bf16 TC "
                 f"{e['tc16_bound_ms']:.4f}" if "tc16_bound_ms" in e else "")
              + (f"  f32 kernel {e['f32_kernel_ms']:.4f} ms"
                 if "f32_kernel_ms" in e else "")
              + ("" if e["library_ms"] is None else
                 f"  cuDNN bf16 {e['library_ms']:.4f} ms vs kernel "
                 f"{e['ms_library_shapes']:.4f} ms at "
                 f"{len(e['library_shapes'])} shapes"))
    for k, r in readings.items():
        print(f"time  {k:19s} bf16 through the wrapper {r['ms']:.4f} ms "
              f"(the float32 kernel on the same values {r['f32_kernel_ms']:.4f}"
              f" ms; A, F, E: the rest the widening and rounding passes; B: "
              f"its bf16 form)  bound at bf16 bytes {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})")
    return entries, readings, record_rows


def bf16_phases(counters, record, train, shapes):
    """Phases 32-35 (``shapes``: phase 4's rows, whose bf16 forward and
    input-cotangent errors the kernel line takes). Returns the kernel
    line's bf16 entries and the warps' bf16 readings."""
    errs, ops_in = check_bf16_kernels(train, record)
    for k in ("gb", "va", "vb"):
        ops_in[k + "32"] = ops_in[k].float()
    steps, batches = bf16_steps(counters, record, train)
    record["bf16_steps"] = steps
    record["bf16_card_vs_cpu"] = bf16_card_vs_cpu(batches)
    record["bf16_train_step"] = time_steps(batches)
    entries, readings, rows = time_bf16_kernels(ops_in, steps)
    record["bf16_train_shapes"] = rows
    errs["conv3x3"] = max(r["max_abs_err_bf16"] for r in shapes)
    errs["conv3x3_dx"] = max(r["dx_max_abs_err_bf16"] for r in shapes)
    for e in entries:
        base = e["name"][:-len("_bf16")]
        e["max_abs_err"] = errs[base]
        if base == "conv3x3_bn":
            e["max_abs_err_moments"] = errs["conv3x3_bn_mom"]
    return entries, readings


# ------------------------------------------------ every recipe's bf16 step


def check_mei_bf16(scene):
    """Phase 36: kernels G and H in bfloat16 against their plain versions on
    the card at the fisheye recipe's shape (128 warps of 384x384x3 against
    32 sources and 16 masks, band 16), the bf16 image beside a float32 norm
    (the bf16 step's: its decoded norms are float32, as the depth bins are)
    and beside a bfloat16 one: G on each route :data:`PROJ_REPEATS` times in
    turns, out, va, vb and the overlap bitwise; H :data:`PROJ_REPEATS`
    times, within B's bf16 gate (1e-6 of the largest entry, and one bf16
    ulp beyond it where d norm is bfloat16). Then the conv kernels'
    bfloat16 forms at the distillation step's four Co = 1 uncertainty convs
    (bs8 @288x512), :data:`REPEATS` launches each: the forward and the input
    cotangent within one bf16 ulp beyond 2e-5 of the largest entry and
    bitwise launch to launch, the float32 weight cotangent within 2e-5
    (phase 32's gates). Returns the max abs errors by kernel and the
    operands phase 39 times."""
    from fsnet_tpu_torch.ops import conv3x3 as tc
    from fsnet_tpu_torch.ops import warp_mei as twm
    from fsnet_tpu_torch.ops.warp_depth import proj_route

    image, mask, norm, rays, rows = scene
    S, F, N = S_SCALES, F_FRAMES, rows.shape[0]
    img = image.to(BF16)
    errs = dict(warp_mei_fwd=0.0, warp_mei_bwd=0.0)
    ops = None
    for tag, nrm in (("float32", norm), ("bfloat16", norm.to(BF16))):
        route = proj_route(img, mask, nrm, rays, rows)
        check(route == "vector", f"kernel G bf16, {tag} norm: route {route}")
        ref = twm.warp_mei_plain(img, mask, nrm, rays, rows, S, F, FISH_BAND,
                                 True)
        check_routes(
            f"kernel G bf16 N={N} {FISH_H}x{FISH_W}, {tag} norm",
            lambda r: twm._launch_fwd(r, img, mask, nrm, rays, rows, S, F,
                                      FISH_BAND, True), ref)
        gb = torch.randn(ref[0].shape, device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(9)).to(BF16)
        dn_ref = twm.warp_mei_bwd_plain(nrm, rays, gb, ref[2], ref[3], rows,
                                        S, F)
        den = dn_ref.float().abs().max().item()
        worst = 0.0
        for _ in range(PROJ_REPEATS):
            dn = twm.warp_mei_bwd(nrm, rays, gb, ref[2], ref[3], rows, S, F)
            torch.cuda.synchronize()
            check(dn.dtype == nrm.dtype, f"kernel H bf16, {tag} norm: d norm "
                  f"{dn.dtype}")
            diff = (dn.float() - dn_ref.float()).abs()
            errs["warp_mei_bwd"] = max(errs["warp_mei_bwd"],
                                       diff.max().item())
            if nrm.dtype == BF16:
                big = torch.maximum(dn.float().abs(), dn_ref.float().abs())
                diff = (diff - bf16_ulp(big)).clamp(min=0.0)
            worst = max(worst, diff.max().item() / den)
        print(f"check kernel H bf16 N={N} {FISH_H}x{FISH_W}, {tag} norm "
              f"x{PROJ_REPEATS}: d norm ({tag}) beyond "
              + ("one bf16 ulp " if nrm.dtype == BF16 else "")
              + f"{worst:.2e} of the largest entry (gate 1e-6)")
        check(worst <= 1e-6, f"kernel H bf16, {tag} norm: {worst:.2e} of "
              "the largest entry > 1e-6")
        if ops is None:
            ops = dict(image=img, mask=mask, norm=nrm, rays=rays, rows=rows,
                       gb=gb, va=ref[2], vb=ref[3])

    B = NUSC_BATCH
    for i, (name, H, W, Cs, Co, pad) in enumerate(
            s for s in DISTILL_SHAPES if s[0].startswith("uncertain_")):
        parts, w, b = conv_inputs(B, H, W, Cs, Co, BF16, seed=200 + i)
        gy = torch.randn(B, H, W, Co, device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(300 + i)).to(BF16)
        inputs = {f"x{j}": p for j, p in enumerate(parts)}
        inputs.update(w=w, b=b, gy=gy)
        at = f"bf16_{name}"
        wide = [p.double() for p in parts]
        held = dict(
            conv3x3=HeldUlp(f"{at}_conv", tc.conv3x3_plain(parts, w, b, pad),
                            2e-5, True, inputs,
                            lambda: tc._conv_core(wide, w.double(),
                                                  b.double(), pad)),
            conv3x3_dx=HeldUlp(f"{at}_dx", tc.conv3x3_dx_plain(gy, w, pad,
                                                               Cs)[0],
                               2e-5, True, inputs,
                               lambda: tc.conv3x3_dx_plain(
                                   gy.double(), w.double(), pad, Cs)[0]),
            conv3x3_dw=Held(f"{at}_dw", tc.conv3x3_dw_plain(parts, gy, pad),
                            2e-5, False, inputs,
                            lambda: tc.conv3x3_dw_plain(wide, gy.double(),
                                                        pad)))
        for _ in range(REPEATS):
            got = dict(conv3x3=tc.conv3x3(parts, w, b, pad),
                       conv3x3_dx=tc.conv3x3_dx(gy, w, pad, Cs)[0],
                       conv3x3_dw=tc.conv3x3_dw(parts, gy, pad))
            torch.cuda.synchronize()
            check(got["conv3x3"].dtype == got["conv3x3_dx"].dtype == BF16
                  and got["conv3x3_dw"].dtype == torch.float32,
                  f"{at}: output dtypes")
            for k, v in got.items():
                held[k](v)
        for k, h in held.items():
            errs[f"{k}_co1"] = max(errs.get(f"{k}_co1", 0.0), h.d)
        print(f"check bf16 {name:17s} B{B} {H}x{W} {Cs[0]}->{Co} "
              f"x{REPEATS}: rel err conv {held['conv3x3'].e:.2e} "
              f"({held['conv3x3'].share:.2e} not bitwise equal, all within "
              f"one bf16 ulp) dx {held['conv3x3_dx'].e:.2e} "
              f"({held['conv3x3_dx'].share:.2e}) dw "
              f"{held['conv3x3_dw'].e:.2e}")
    return errs, ops


def recipe_cases(fish):
    """The shipped recipes that train at bf16 beside the flagship: (build,
    recipe, meta-arch config for the optimizer, batch, (B, H, W)) by
    name."""
    from fsnet_tpu_torch.entry import (FISHEYE_RECIPE, NUSC_RECIPE,
                                       distill_config, distill_model,
                                       fisheye_model, flagship_model,
                                       nusc_model)

    def distill(h, w, device="cuda", seed=0):
        src = flagship_model(h, w, device="cpu", seed=1).state_dict()
        return distill_model(h, w, device=device, seed=seed,
                             teacher_state=src)

    nb = nusc_batch_np()
    nsize = (NUSC_BATCH, NUSC_H, NUSC_W)
    return dict(
        fisheye=(fisheye_model, FISHEYE_RECIPE, None, fish["batch"],
                 (FISH_BATCH, FISH_H, FISH_W)),
        nusc=(nusc_model, NUSC_RECIPE, None, nb, nsize),
        distill=(distill, NUSC_RECIPE, distill_config(NUSC_H, NUSC_W), nb,
                 nsize))


def recipe_bf16_steps(counters, record, cases):
    """Phase 37: one bf16 step of the fisheye (bs16 @384x384), the
    ``nusc_wpose`` and the ``distill_nusc`` recipes (bs8 @288x512), each
    through ``make_train_step("cuda", compute_dtype=recipe[
    "compute_dtype"])`` with its recipe's optimizer, the launch counters
    set to 0 just before and read just after: the launches per kernel of
    the recipe's float32 step (phases 19, 27, 29), every kernel that has a
    bf16 form (the conv kernels, G, H, I, J) on bf16 operands (the
    wrappers' counts by dtype), F and E on their float32 kernels (the
    image widened at the wrapper); the routes as at float32; bf16 warped
    frames into the loss; the distillation teacher (its parameters and BN
    statistics) bitwise unchanged; the lane-window count on the step's own
    depths."""
    from fsnet_tpu_torch.entry import recipe_optimizer
    from fsnet_tpu_torch.ops import warp_fast as twf
    from fsnet_tpu_torch.ops import warp_mei as twm
    from fsnet_tpu_torch.runtime.state import make_train_step

    wants = dict(fisheye=record["fisheye_path"]["launches_per_step"],
                 nusc=record["nusc_path"]["launches_per_step"],
                 distill=record["distill_path"]["launches_per_step"])
    out = {}
    for name, (build, recipe, cfg, batch, (B, H, W)) in cases.items():
        want = wants[name]
        model = build(H, W, device="cuda", seed=0)
        opt, _ = recipe_optimizer(model, recipe, cfg)
        step = make_train_step("cuda", compute_dtype=recipe["compute_dtype"])
        kept = {n: t.clone() for n, t in model.state_dict().items()
                if n.startswith("teacher_net.")}
        p0 = [p.detach().clone() for p in opt.params]
        seen, release = capture_warp(model)
        zero(counters)
        met = step(model, opt, batch)
        torch.cuda.synchronize()
        counts = read(counters)
        dtypes = {k: dict(fn.dtypes) for k, fn in counters.items()
                  if hasattr(fn, "dtypes")}
        rts = routes(counters)
        release()
        loss = float(met["loss"])
        what = f"bf16 {name} step bs{B}@{H}x{W}"
        check(np.isfinite(loss), f"{what}: loss {loss}")
        check(counts == want, f"{what}: launches {counts}, expected {want}")
        # kernel E has its bf16 form on the channel-wide route only: the
        # mask's E (row route) runs its float32 kernel on the widened mask
        wide = dict(warp_grid_fwd=want["warp_grid_fwd"])
        bad = {k: d for k, d in dtypes.items()
               if d != dict(float32=wide.get(k, 0),
                            bfloat16=want[k] - wide.get(k, 0))}
        check(not bad, f"{what}: launches by dtype {bad}")
        check(all(counts[k] for k in ("conv3x3", "conv3x3_bn", "conv3x3_dx",
                                      "conv3x3_dw", "photo_loss_fwd",
                                      "photo_loss_bwd")),
              f"{what}: a bf16 kernel of the path did not launch: {counts}")
        wanted = dict(photo_loss_fwd=dict(narrow=0, vector=2),
                      photo_loss_bwd=dict(narrow=0, vector=1))
        if want["warp_mei_fwd"]:
            wanted["warp_mei_fwd"] = dict(narrow=0, vector=1)
        if want["warp_grid_fused"]:
            wanted["warp_grid_fused"] = dict(narrow=0, row=1)
            wanted["warp_grid_fwd"] = dict(narrow=0, vector=0,
                                           row=want["warp_grid_fwd"])
        bad = {k: rts[k] for k, r in wanted.items() if rts[k] != r}
        check(not bad, f"{what}: routes {bad}, expected {wanted}")
        check(seen["preds"].dtype == BF16, f"{what}: the loss saw "
              f"{seen['preds'].dtype} warped frames")
        state = model.state_dict()
        moved_teacher = [n for n, t in kept.items()
                         if not torch.equal(state[n], t)]
        check(not moved_teacher, f"{what}: {len(moved_teacher)} of the "
              f"teacher's {len(kept)} tensors changed: {moved_teacher[:5]}")
        moved = sum(int(not torch.equal(p.detach(), q))
                    for p, q in zip(opt.params, p0))
        check(moved >= len(p0) - 10, f"{what}: {moved} of {len(p0)} "
              "parameters moved")
        depth = seen["depths"].reshape(S_SCALES * B, H, W)
        t = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
        if name == "fisheye":
            # the step's own norms through the cast batch's rays, camera
            # and poses, widened
            rays = t["fisheye_rays"].to(BF16).float()
            mrows = twm.make_mei_rows(
                t["P2"].to(BF16).float(),
                t["fisheye_params"].to(BF16).float(),
                torch.stack([t[f"relative_pose/{f}"] for f in (1, -1)])
                .to(BF16).float(), S_SCALES)
            x = twm.mei_pix(depth, rays[..., :3].permute(0, 3, 1, 2)
                            .contiguous(), mrows, S_SCALES, F_FRAMES)["x"]
            lane = dict(photometric=lane_window_moves(x, W))
        else:
            sources = torch.cat([t[f"original_image/{f}"] for f in (1, -1)])
            grid = grid_scene(batch, sources, depth)[2]
            x = twf.unnormalize(grid[..., 0], W)
            lane = dict(photometric=lane_window_moves(x, W),
                        mask=lane_window_moves(x, W, nearest=True))
        out[name] = dict(loss=loss, launches=counts, dtypes=dtypes,
                         routes={k: rts[k] for k in wanted},
                         params_moved=moved, params=len(p0),
                         teacher_bitwise=len(kept), lane_window_moves=lane,
                         samples=x.numel(), depth_min=float(depth.min()),
                         depth_max=float(depth.max()))
        print(f"{what} (compute_dtype {recipe['compute_dtype']!r}): loss "
              f"{loss:.6f}, launches {counts}, by dtype "
              f"{ {k: d for k, d in dtypes.items() if want[k]} }, routes "
              f"{out[name]['routes']}, {moved} of {len(p0)} parameters "
              f"moved" + (f", the teacher's {len(kept)} tensors bitwise "
                          "unchanged" if kept else "")
              + f"; on the step's own depths (in "
              f"[{out[name]['depth_min']:.3f}, {out[name]['depth_max']:.3f}]"
              f" m) the TPU lane-window clamp would move {lane} of "
              f"{x.numel()} samples")
        del model, opt, seen, x
    return out


def recipe_bf16_vs_cpu(cases):
    """Phase 38: one bf16 step of each recipe at batch 2 on the card and
    through the port on the CPU, from the same seeded weights, on smooth
    textures (the nuScenes batch's own; the synthetic batch's in place of
    the fisheye batch's white noise, on which the float32 and bf16 losses
    lie within 2e-4), held to phase 34's loss gates (for the distillation
    step on its loss less the distillation terms) and its gradient gates
    against the control (:func:`bf16_vs_cpu`'s ``against_control``)."""
    from fsnet_tpu_torch.entry import recipe_optimizer, synthetic_batch

    out = {}
    for name, (build, recipe, cfg, batch, (_, H, W)) in cases.items():
        small = {k: v[:2] for k, v in batch.items()}
        if name == "fisheye":
            small.update((k, v) for k, v in synthetic_batch(2, H, W).items()
                         if k.startswith(("image/", "original_image/")))
        out[name] = bf16_vs_cpu(
            build, small, name, H, W, recipe["compute_dtype"],
            lambda m, recipe=recipe, cfg=cfg: recipe_optimizer(m, recipe,
                                                               cfg),
            against_control=True, reprojection=name == "distill")
    return out


def time_recipe_steps(cases):
    """Phase 39: each recipe's step at its batch in float32 and in bf16, as
    phase 35 times the flagship's (:func:`time_step`)."""
    from fsnet_tpu_torch.entry import recipe_optimizer

    out = {}
    for name, (build, recipe, cfg, batch, (B, H, W)) in cases.items():
        def build_opt(build=build, recipe=recipe, cfg=cfg, H=H, W=W):
            model = build(H, W, device="cuda", seed=0)
            return model, recipe_optimizer(model, recipe, cfg)[0]
        for tag, cdt in (("f32", None), ("bf16", recipe["compute_dtype"])):
            out[f"{name}_{tag}"] = time_step(
                build_opt, batch, cdt, f"{name} {tag} bs{B}@{H}x{W}", B)
    return out


def time_mei_bf16(ops, steps, errs):
    """Phase 39: kernels G and H in bfloat16 at the fisheye recipe's shape
    on the bf16 step's operand types (a float32 norm), for the kernel line:
    G on each route in turns, H; beside the float32 kernels on the same
    values, the plain versions and the bounds at bf16 bytes."""
    from fsnet_tpu_torch.ops import warp_mei as twm

    o = ops
    img, mask, norm, rays, rows = (o[k] for k in ("image", "mask", "norm",
                                                  "rays", "rows"))
    S, F, N = S_SCALES, F_FRAMES, rows.shape[0]
    FB, C, SB, B = img.shape[0], img.shape[-1], norm.shape[0], rays.shape[0]
    plane, px, nb = FISH_H * FISH_W, N * FISH_H * FISH_W, norm.element_size()
    # the bytes G and H must move: the image, g, va, vb and the outputs in
    # bf16, the norm (and d norm) in its dtype, rays, mask and rows float32
    g_bytes = (2.0 * FB * plane * C + nb * SB * plane
               + 4.0 * (4 * B * plane + N * 24) + px * (3 * 2.0 * C + 1))
    h_bytes = (2.0 * nb * SB * plane + 4.0 * (3 * B * plane + N * 24)
               + 3 * 2.0 * px * C)
    fish = steps["fisheye"]
    # the float32 kernels' operands, widened once outside the timings
    img32, gb32, va32, vb32 = (t.float() for t in (img, o["gb"], o["va"],
                                                   o["vb"]))
    src = "fsnet_tpu_torch/csrc/warp_mei.cu"
    note = (f"bfloat16 image (g, va, vb) beside a float32 norm, the bf16 "
            f"step's operands: N={N} warps of {FISH_H}x{FISH_W}x{C}, band "
            f"{FISH_BAND}; launches: one bf16 fisheye step (phase 37); "
            "f32_kernel_ms: the float32 kernel on the same values; bound at "
            "bf16 bytes")
    g = dict(name="warp_mei_fwd_bf16", form="bf16", route="cuda", source=src,
             replaces="fsnet_tpu/ops/pallas/mei_prep_kernel.py:99 + "
                      "fsnet_tpu/ops/pallas/warp_kernel.py:1022",
             launches=fish["dtypes"]["warp_mei_fwd"]["bfloat16"],
             max_abs_err=errs["warp_mei_fwd"],
             plain_ms=cuda_ms(lambda: twm.warp_mei_plain(
                 img, mask, norm, rays, rows, S, F, FISH_BAND, True),
                 iters=3, warmup=1),
             f32_kernel_ms=cuda_ms(lambda: twm._launch_fwd(
                 "vector", img32, mask, norm, rays, rows, S, F, FISH_BAND,
                 True), iters=10),
             library_ms=None, note=note)
    g["bound_ms"], g["bound_by"] = ms_bound(px * (80.0 + 15.0 * C), g_bytes)
    time_routes(g, {r: (lambda r=r: twm._launch_fwd(
        r, img, mask, norm, rays, rows, S, F, FISH_BAND, True))
        for r in PROJ_ROUTES}, fish["routes"]["warp_mei_fwd"])
    h = dict(name="warp_mei_bwd_bf16", form="bf16", route="cuda", source=src,
             replaces="fsnet_tpu/ops/pallas/mei_prep_kernel.py:209",
             launches=fish["dtypes"]["warp_mei_bwd"]["bfloat16"],
             max_abs_err=errs["warp_mei_bwd"],
             ms=cuda_ms(lambda: twm.warp_mei_bwd(norm, rays, o["gb"], o["va"],
                                                 o["vb"], rows, S, F),
                        iters=10),
             plain_ms=cuda_ms(lambda: twm.warp_mei_bwd_plain(
                 norm, rays, o["gb"], o["va"], o["vb"], rows, S, F),
                 iters=3, warmup=1),
             f32_kernel_ms=cuda_ms(lambda: twm.warp_mei_bwd(
                 norm, rays, gb32, va32, vb32, rows, S, F), iters=10),
             library_ms=None, note=note)
    h["bound_ms"], h["bound_by"] = ms_bound(px * (101.0 + 4.0 * C), h_bytes)
    for e in (g, h):
        print(f"time  {e['name']:17s} {e['ms']:.4f} ms" + route_line(e)
              + f"  f32 kernel {e['f32_kernel_ms']:.4f} ms  plain "
              f"{e['plain_ms']:.4f} ms  bound at bf16 bytes "
              f"{e['bound_ms']:.4f} ms ({e['bound_by']})  library none")
    return [g, h]


def recipe_bf16_phases(counters, record, fish):
    """Phases 36-39. Returns the kernel line's entries of the bf16 forms of
    kernels G and H, and the conv kernels' errors at Co = 1 in bf16."""
    errs, ops = check_mei_bf16(fish["scene"])
    record["bf16_mei_errs"] = errs
    cases = recipe_cases(fish)
    steps = record["bf16_recipe_steps"] = recipe_bf16_steps(counters, record,
                                                            cases)
    record["bf16_recipe_card_vs_cpu"] = recipe_bf16_vs_cpu(cases)
    record["bf16_recipe_train_step"] = time_recipe_steps(cases)
    return time_mei_bf16(ops, steps, errs), errs


# ------------------------------- the DLA and the pose steps at bf16 (53-56)

def grid_positions(off16, H, W, K, m):
    """Phase 53: the sampling positions (pixels) of a DCN's taps from its
    bfloat16 offsets ``off16``: (the port's: the grid formed in bf16,
    widened, unnormalised in float32; the JAX package's: that grid
    unnormalised in bf16 as its warp does; exact: the grid formed in
    float32 from the same offsets), each (x, y)."""
    from fsnet_tpu_torch.ops import warp_fast as twf
    from fsnet_tpu_torch.ops.dcn import tap_grid

    g16 = tap_grid(off16, H, W, K, m.stride, m.padding, m.dilation)
    exact = tap_grid(off16.float(), H, W, K, m.stride, m.padding,
                     m.dilation)
    out = []
    for c, size in ((0, W), (1, H)):
        jax_like = (g16[..., c] + 1.0) / 2.0 * torch.tensor(size - 1,
                                                            dtype=BF16)
        out.append((twf.unnormalize(g16[..., c].float(), size),
                    jax_like.float(), twf.unnormalize(exact[..., c], size)))
    return g16.float(), out


def check_dcn_bf16(scene):
    """Phase 53: kernels E and K in bfloat16 at the 16 DCN shapes of phase
    23's scene, on its inputs and offsets rounded to bf16 (the grid formed
    in bf16 as the bf16 step forms it, widened): E's bfloat16 form bitwise
    equal to its plain version (the float32 warp of the widened input,
    rounded), K's gfx and gfy within 1e-5 of each one's largest entry and
    bitwise launch to launch, its bfloat16 image cotangent within one bf16
    ulp beyond 1e-5 of its largest entry, each launched
    :data:`WARP_REPEATS` times on the channel-wide route on bfloat16
    operands; the sampling positions of the bf16 grid against the float32
    grid from the same offsets, the port's and the JAX package's (which
    unnormalises in bf16), a reading logged in ROADMAP C; then each
    kernel's time over 10 back-to-back calls beside the float32 kernel on
    the same values, its plain version and its bound at bf16 bytes. Returns
    the kernel line's two entries and the per-shape rows."""
    from fsnet_tpu_torch.ops import warp_fast as twf

    gen = torch.Generator(device="cuda").manual_seed(53)
    rows = []
    errs = dict(warp_grid_fwd=0.0, warp_grid_bwd=0.0)
    t = {k: dict(ms=0.0, f32_kernel_ms=0.0, plain_ms=0.0, ops=0.0,
                 nbytes=0.0) for k in errs}
    for i, (m, x32, _, off) in enumerate(scene):
        _, H, W, C = x32.shape
        K, band = m.weight.shape[0], min(DLA_BAND, H)
        x = x32.to(BF16)
        grid, pos = grid_positions(off.to(BF16), H, W, K, m)
        g = torch.randn((grid.shape[0], H, W, C), device="cuda",
                        generator=gen).to(BF16)
        xw, gw = x.float(), g.float()
        ref = twf.grid_band_plain(xw, grid, "bilinear", "zeros", band,
                                  False)[0].to(BF16)
        refs = twf.grid_band_bwd_plain(xw, grid, gw, "bilinear", "zeros",
                                       band)
        d0 = (dict(twf.grid_band_fwd.dtypes), dict(twf.grid_band_bwd.dtypes))
        r0 = (dict(twf.grid_band_fwd.routes), dict(twf.grid_band_bwd.routes))
        first, e_bwd, bitwise = None, [0.0, 0.0, 0.0], True
        big = refs[2].abs().max().item()
        for _ in range(WARP_REPEATS):
            out = twf.grid_band_fwd(x, grid, "bilinear", "zeros", band)
            got = twf.grid_band_bwd(x, grid, g, "bilinear", "zeros", band)
            torch.cuda.synchronize()
            bitwise = bitwise and out.dtype == BF16 and torch.equal(out, ref)
            for k in range(2):
                e_bwd[k] = max(e_bwd[k], rel_err(got[k], refs[k])[1])
            d = (got[2].float() - refs[2]).abs()
            top = torch.maximum(got[2].float().abs(), refs[2].abs())
            nbad = int((d > bf16_ulp(top) + 1e-5 * big).sum())
            e_bwd[2] = max(e_bwd[2], d.max().item() / big)
            check(got[2].dtype == BF16 and nbad == 0, f"DCN {i} bf16: "
                  f"kernel K's image cotangent: {nbad} elements beyond one "
                  "bf16 ulp + 1e-5 of its largest entry")
            if first is None:
                first = got[:2]
            check(all(torch.equal(a, b) for a, b in zip(got[:2], first)),
                  f"DCN {i} bf16: kernel K's gfx, gfy differ launch to "
                  "launch")
        n = WARP_REPEATS
        for fn, d, r in zip((twf.grid_band_fwd, twf.grid_band_bwd), d0, r0):
            check(fn.dtypes["bfloat16"] - d["bfloat16"] == n
                  and fn.dtypes["float32"] == d["float32"]
                  and fn.routes["vector"] - r["vector"] == n,
                  f"DCN {i} bf16: {fn.__name__} launches by dtype "
                  f"{fn.dtypes}, routes {fn.routes}")
        check(bitwise, f"DCN {i} bf16: kernel E differs from its plain "
              "version")
        check(all(e <= 1e-5 for e in e_bwd[:2]), f"DCN {i} bf16: kernel K "
              f"rel errs {e_bwd[:2]} > 1e-5")
        errs["warp_grid_fwd"] = max(errs["warp_grid_fwd"],
                                    rel_err(out, ref)[0])
        errs["warp_grid_bwd"] = max(errs["warp_grid_bwd"], *(
            rel_err(a, b)[0] for a, b in zip(got, refs)))
        shift = {f"{tag}_{ax}": dict(max=(p - e).abs().max().item(),
                                     mean=(p - e).abs().mean().item())
                 for ax, (port, jax_like, e) in zip("xy", pos)
                 for tag, p in (("port", port), ("jax", jax_like))}
        # timings: bytes at bf16 (image, g, out, dimage), the grid and gfx,
        # gfy float32; operations as phase 26 counts them
        px = grid[..., 0].numel()
        work = dict(
            warp_grid_fwd=(px * (20.0 + 6.0 * C),
                           2.0 * (x.numel() + px * C) + 4.0 * grid.numel()),
            warp_grid_bwd=(px * (20.0 + 20.0 * C),
                           2.0 * (2 * x.numel() + px * C)
                           + 4.0 * (grid.numel() + 2 * px)))
        calls = dict(
            warp_grid_fwd=(
                lambda: twf.grid_band_fwd(x, grid, "bilinear", "zeros",
                                          band),
                lambda: twf.grid_band_fwd(xw, grid, "bilinear", "zeros",
                                          band),
                lambda: twf.grid_band_plain(xw, grid, "bilinear", "zeros",
                                            band, False)[0].to(BF16)),
            warp_grid_bwd=(
                lambda: twf.grid_band_bwd(x, grid, g, "bilinear", "zeros",
                                          band),
                lambda: twf.grid_band_bwd(xw, grid, gw, "bilinear", "zeros",
                                          band),
                lambda: twf.grid_band_bwd_plain(xw, grid, gw, "bilinear",
                                                "zeros", band)))
        row = dict(input=list(x.shape), grid=list(grid.shape),
                   bwd_rel_err=e_bwd, positions_px=shift)
        for k, (own, f32, plain) in calls.items():
            ms = cuda_ms(own, iters=10)
            b_ms, b_by = ms_bound(*work[k])
            row[k] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by)
            t[k]["ms"] += ms
            t[k]["f32_kernel_ms"] += cuda_ms(f32, iters=10)
            t[k]["plain_ms"] += cuda_ms(plain, iters=1, warmup=1)
            t[k]["ops"] += work[k][0]
            t[k]["nbytes"] += work[k][1]
        rows.append(row)
        print(f"check DCN {i:2d} bf16 {tuple(x.shape)}: kernel E bitwise "
              f"{bitwise}, kernel K rel err gfx {e_bwd[0]:.2e} gfy "
              f"{e_bwd[1]:.2e} dimage {e_bwd[2]:.2e} (one bf16 ulp + 1e-5 "
              f"held), x{WARP_REPEATS} launches, channel-wide route, bf16 "
              f"operands; positions (px, max/mean) port x "
              f"{shift['port_x']['max']:.4f}/{shift['port_x']['mean']:.5f} y "
              f"{shift['port_y']['max']:.4f}/{shift['port_y']['mean']:.5f}, "
              f"JAX's bf16 unnormalise x {shift['jax_x']['max']:.4f}/"
              f"{shift['jax_x']['mean']:.5f} y {shift['jax_y']['max']:.4f}/"
              f"{shift['jax_y']['mean']:.5f}; E "
              f"{row['warp_grid_fwd']['ms']:.4f} ms, K "
              f"{row['warp_grid_bwd']['ms']:.4f} ms")
        del x, grid, g, xw, gw, ref, refs, out, got, first
    src = "fsnet_tpu_torch/csrc/"
    meta = dict(
        warp_grid_fwd=(src + "warp_grid.cu",
                       "fsnet_tpu/ops/pallas/warp_kernel.py:752 + "
                       "warp_kernel.py:1115"),
        warp_grid_bwd=(src + "warp_grad.cu",
                       "fsnet_tpu/ops/pallas/warp_kernel.py:815 + "
                       "warp_kernel.py:1169"))
    entries = []
    for k, e in t.items():
        b_ms, b_by = ms_bound(e["ops"], e["nbytes"])
        entries.append(dict(
            name=k + "_bf16", form="bf16", route="cuda", source=meta[k][0],
            replaces=meta[k][1], launches=None, max_abs_err=errs[k],
            ms=e["ms"], plain_ms=e["plain_ms"], bound_ms=b_ms, bound_by=b_by,
            library_ms=None, f32_kernel_ms=e["f32_kernel_ms"],
            note="bfloat16 operands, the channel-wide route: sums over the "
                 f"16 DCNs of one bs{BATCH} @{HEIGHT}x{WIDTH} DLA step (9 "
                 "taps each as one grid batch), bilinear, zeros, band "
                 f"{DLA_BAND}; launches: one bf16 DLA step (phase 54); "
                 "f32_kernel_ms: the float32 kernel on the same values; "
                 "bound at bf16 bytes" + ("; ms includes the rounding of "
                                          "the float32 sums" if k ==
                                          "warp_grid_bwd" else "")))
        print(f"time  {k}_bf16 summed over 16 DCNs: {e['ms']:.4f} ms  "
              f"f32 kernel {e['f32_kernel_ms']:.4f} ms  plain "
              f"{e['plain_ms']:.4f} ms  bound at bf16 bytes {b_ms:.4f} ms "
              f"({b_by})  library none")
    worst = {k: max(r["positions_px"][k]["max"] for r in rows)
             for k in rows[0]["positions_px"]}
    print(f"DCN bf16 grid positions against the float32 grid from the same "
          f"offsets, worst over 16 DCNs (px): {worst}")
    return entries, rows


def step_launches(counters, step, model, opt, batch, want, what,
                  bf16_kernels=()):
    """Phases 54-56: one train step with the counters set to 0 just before
    and read just after: the launches per kernel equal ``want``, and those
    of ``bf16_kernels`` all on bfloat16 operands (the wrappers' dtype
    counts); a finite loss. Returns the launches, dtypes and routes."""
    zero(counters)
    met = step(model, opt, batch)
    torch.cuda.synchronize()
    counts = read(counters)
    dtypes = {k: dict(fn.dtypes) for k, fn in counters.items()
              if hasattr(fn, "dtypes")}
    rts = routes(counters)
    loss = float(met["loss"])
    print(f"{what}: loss {loss:.6f}, launches {counts}, by dtype "
          f"{ {k: d for k, d in dtypes.items() if want[k]} }, routes "
          f"{ {k: r for k, r in rts.items() if want[k]} }")
    check(np.isfinite(loss), f"{what}: loss {loss}")
    check(counts == want, f"{what}: launches {counts}, expected {want}")
    bad = {k: dtypes[k] for k in bf16_kernels
           if dtypes[k] != dict(float32=0, bfloat16=want[k])}
    check(not bad, f"{what}: launches by dtype {bad}")
    return dict(loss=loss, launches=counts, dtypes=dtypes, routes=rts)


def dla_bf16_vs_cpu(small, H=HEIGHT, W=WIDTH):
    """Phase 54: one bf16 DLA step at batch 2 with every BN on its init
    statistics (``dla_model(norm_frozen=True)``, as phase 25) on the card
    and through the port on the CPU, at phase 34's gates: loss rel < 2e-2;
    gradients global rel-L2 < 0.3 and every leaf < 0.6 against the CPU
    port's bf16 ones; gradient cosine against the card's float32 step >
    0.25; every leaf bf16-valued. The card's float32 step is the control:
    the DLA's loss sums the whole output, where bf16 and float32 part by
    less than 2e-2, so the control must miss the gradients instead: the
    bf16 gradients lie under half the control's global rel-L2 from the
    CPU's (two bf16 steps share the rounding of the parameters and of the
    sampling grids)."""
    from fsnet_tpu_torch.entry import dla_model

    build = functools.partial(dla_model, norm_frozen=True)
    l16, g16, _ = one_step(build, small, "cuda", H, W,
                           compute_dtype="bfloat16")
    l16c, g16c, _ = one_step(build, small, "cpu", H, W,
                             compute_dtype="bfloat16")
    l32, g32, _ = one_step(build, small, "cuda", H, W)
    kept = [k for k in g16c if bool(g16c[k].any())]

    def worst_leaf(g):
        leaf = {k: float((g[k] - g16c[k]).norm() / g16c[k].norm())
                for k in kept}
        worst = max(leaf, key=leaf.get)
        return worst, leaf[worst]

    a = torch.cat([g16[k].flatten() for k in sorted(g16)])
    b = torch.cat([g32[k].flatten() for k in sorted(g32)])
    out = dict(loss_rel=abs(l16 - l16c) / abs(l16c),
               control_f32_loss_rel=abs(l32 - l16c) / abs(l16c),
               grad_rel_l2=grad_rel_l2(g16, g16c),
               control_f32_grad_rel_l2=grad_rel_l2(g32, g16c),
               grad_cosine_vs_f32=float(a @ b / (a.norm() * b.norm())),
               leaves_not_bf16=[k for k, g in g16.items()
                                if not torch.equal(g, g.to(BF16).double())])
    (out["worst_leaf"], out["worst_leaf_rel_l2"]) = worst_leaf(g16)
    out["control_f32_worst_leaf_rel_l2"] = worst_leaf(g32)[1]
    print(f"bf16 card vs CPU port, DLA step (BN frozen) bs2@{H}x{W}: loss "
          f"{l16:.6f} vs {l16c:.6f} (rel {out['loss_rel']:.2e}, gate 2e-2; "
          f"the card's f32 step {l32:.6f}, rel "
          f"{out['control_f32_loss_rel']:.2e}); gradients global rel-L2 "
          f"{out['grad_rel_l2']:.3e} (gates 0.3 and half the control's), "
          f"worst leaf {out['worst_leaf']} {out['worst_leaf_rel_l2']:.3e} "
          f"(gate 0.6); the card's f32 gradients against the same "
          f"{out['control_f32_grad_rel_l2']:.3e}, "
          f"{out['control_f32_worst_leaf_rel_l2']:.3e}; cosine against the "
          f"card's f32 step {out['grad_cosine_vs_f32']:.5f}; leaves not "
          f"bf16-valued {len(out['leaves_not_bf16'])}")
    check(out["loss_rel"] < 2e-2, f"bf16 DLA: card vs CPU loss rel "
          f"{out['loss_rel']:.2e}")
    check(out["grad_rel_l2"] < min(0.3, 0.5 * out["control_f32_grad_rel_l2"])
          and out["worst_leaf_rel_l2"] < 0.6, f"bf16 DLA: card vs CPU "
          f"gradients {out['grad_rel_l2']:.3e}, worst leaf "
          f"{out['worst_leaf_rel_l2']:.3e}; control "
          f"{out['control_f32_grad_rel_l2']:.3e}")
    check(out["grad_cosine_vs_f32"] > 0.25 and not out["leaves_not_bf16"],
          f"bf16 DLA: cosine {out['grad_cosine_vs_f32']:.4f}, leaves not "
          f"bf16-valued {out['leaves_not_bf16'][:5]}")
    return out


# the launches of one learned-pose or residual-pose step (the grid route
# without a mask: kernel F once, E none)
POSE_STEP = dict(conv3x3=4, conv3x3_bn=10, conv3x3_dx=14, conv3x3_dw=14,
                 warp_grid_fused=1, photo_loss_fwd=2, photo_loss_bwd=1)
BF16_CONV_PHOTO = ("conv3x3", "conv3x3_bn", "conv3x3_dx", "conv3x3_dw",
                   "photo_loss_fwd", "photo_loss_bwd")


def bf16_model_phases(counters, record):
    """Phases 53-56. Returns the kernel line's entries of the bf16 forms of
    kernels E and K."""
    from fsnet_tpu_torch.entry import (FLAGSHIP_RECIPE, dla_batch,
                                       dla_model, flagship_optimizer,
                                       learned_pose_model,
                                       residual_pose_model)
    from fsnet_tpu_torch.runtime.state import make_train_step

    B, H, W = BATCH, HEIGHT, WIDTH
    cdt = FLAGSHIP_RECIPE["compute_dtype"]
    size = f"bs{B}@{H}x{W}"

    # 53. E and K in bf16 at the 16 DCN shapes
    batch = dla_batch(B, H, W)
    model = dla_model(H, W, device="cuda", seed=0)
    scene = dcn_scene(model, torch.from_numpy(batch["image/0"]).cuda())
    entries, record["dla_dcn_bf16"] = check_dcn_bf16(scene)
    del scene

    # 54. the DLA's bf16 step: launches, card vs CPU, timings
    want = dict.fromkeys(counters, 0)
    want.update(warp_grid_fwd=16, warp_grid_bwd=16)
    opt, _ = flagship_optimizer(model)
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    dla = record["dla_bf16_step"] = step_launches(
        counters, make_train_step("cuda", compute_dtype=cdt), model, opt,
        batch, want, f"bf16 DLA step {size}",
        ("warp_grid_fwd", "warp_grid_bwd"))
    for k in ("warp_grid_fwd", "warp_grid_bwd"):
        check(dla["routes"][k]["vector"] == 16, f"bf16 DLA step: {k} routes "
              f"{dla['routes'][k]}, expected all 16 channel-wide")
    moved = sum(int(not torch.equal(p.detach(), p0[n]))
                for n, p in model.named_parameters())
    check(moved >= len(p0) - 10, f"bf16 DLA step: {moved} of {len(p0)} "
          "parameters moved")
    del model, opt, p0
    for e in entries:
        e["launches"] = dla["dtypes"][e["name"].removesuffix("_bf16")][
            "bfloat16"]
    small = {k: v[:2] for k, v in batch.items()}
    record["dla_bf16_card_vs_cpu"] = dla_bf16_vs_cpu(small)

    def model_opt(build, **kw):
        def build_opt():
            m = build(H, W, device="cuda", seed=0, **kw)
            return m, flagship_optimizer(m)[0]
        return build_opt

    record["dla_bf16_train_step"] = {
        tag: time_step(model_opt(dla_model), batch, c, f"DLA {tag} {size}", B)
        for tag, c in (("f32", None), ("bf16", cdt))}

    # 55-56. the learned-pose MonoDepthMeta and the residual-pose
    # MonoDepthWPose: one step at f32 and at bf16 with their launches,
    # card vs CPU at bs2 on the synthetic batch's textures, timings
    pose_batch = {k: v for k, v in flagship_masked_np().items()
                  if k != "patched_mask"}
    small = {k: v[:2] for k, v in pose_batch.items()}
    want = dict.fromkeys(counters, 0)
    want.update(POSE_STEP)
    for name, build in (("learned_pose", learned_pose_model),
                        ("residual_pose", residual_pose_model)):
        rec = record[f"{name}_bf16"] = {}
        for tag, c in (("f32", None), ("bf16", cdt)):
            m, o = model_opt(build)()
            rec[f"launches_{tag}"] = step_launches(
                counters, make_train_step("cuda", compute_dtype=c), m, o,
                pose_batch, want, f"{name} {tag} step {size}",
                BF16_CONV_PHOTO if c else ())
            check(rec[f"launches_{tag}"]["routes"]["warp_grid_fused"]
                  == dict(narrow=0, row=1), f"{name} {tag}: kernel F "
                  "off its row route")
            del m, o
        if name == "residual_pose":
            rec["card_vs_cpu_f32"] = card_vs_cpu(
                residual_pose_model, small, "residual-pose train step")
        # phase 55 at phase 38's gates (the gradients below the control's
        # distances), phase 56 at phase 34's
        rec["card_vs_cpu_bf16"] = bf16_vs_cpu(
            build, small, name, H, W, cdt,
            against_control=name == "learned_pose")
        rec["train_step"] = {
            tag: time_step(model_opt(build), pose_batch, c,
                           f"{name} {tag} {size}", B)
            for tag, c in (("f32", None), ("bf16", cdt))}
    return entries


# ----------------------------------------------- training from a dataset

# the flagship recipe on the synthetic dataset (phases 40-41)
FLAGSHIP_CONFIG = (Path(__file__).resolve().parent / "fsnet_tpu_torch"
                   / "configs" / "synthetic_flagship.py")
LOOP_DIR = Path(__file__).resolve().parent / "build" / "train_loop"
# phase 40: 36 training samples (3 steps an epoch), 2 epochs, then one more
# from the checkpoint; the val split's samples
LOOP_SAMPLES, LOOP_EPOCHS, LOOP_VAL = 36, 2, 4


class LoopWatch:
    """Wraps the training hook and the optimizer for phase 40: the launch
    counters set to 0 just before each step and read just after (by dtype
    and route too), the batch's ``keep`` keys, each step's tie-break noise,
    the (count, lr) of each update, and, at the first step of a run given
    ``expect``, the model's state_dict and the optimizer's moments and
    count against it."""

    def __init__(self, counters, keep=()):
        from fsnet_tpu_torch.pipeline_hooks import train_val_hooks as hooks
        from fsnet_tpu_torch.runtime import optim

        self.counters, self.hooks, self.optim = counters, hooks, optim
        self.steps, self.noise, self.lrs = [], [], []
        # batch keys whose values each step's entry keeps (on the host)
        self.keep = tuple(keep)
        self.expect, self.restored = None, None
        hook_call, noise, step = (hooks.BaseTrainingHook.__call__,
                                  hooks.BaseTrainingHook.noise,
                                  optim.Adam.step)
        self.saved = hook_call, noise, step
        watch = self

        def counted(hook, data, model, optimizer, **kw):
            if watch.expect is not None:
                watch.restored = restored_bitwise(model, optimizer,
                                                  watch.expect)
                watch.expect = None
            zero(counters)
            out = hook_call(hook, data, model, optimizer, **kw)
            torch.cuda.synchronize()
            watch.steps.append(dict(
                launches=read(counters), routes=routes(counters),
                dtypes={k: dict(fn.dtypes) for k, fn in counters.items()
                        if hasattr(fn, "dtypes")},
                batch={k: (data[k].cpu() if isinstance(data[k], torch.Tensor)
                           else data[k]) for k in watch.keep}))
            return out

        def drawn(hook, model, data, step):
            n = noise(hook, model, data, step)
            watch.noise.append(n.clone())
            return n

        def stepped(opt, grads):
            watch.lrs.append((opt.count, opt.schedule(opt.count)))
            return step(opt, grads)

        hooks.BaseTrainingHook.__call__ = counted
        hooks.BaseTrainingHook.noise = drawn
        optim.Adam.step = stepped

    def close(self):
        (self.hooks.BaseTrainingHook.__call__,
         self.hooks.BaseTrainingHook.noise, self.optim.Adam.step) = self.saved


def restored_bitwise(model, optimizer, payload):
    """Whether ``model`` and ``optimizer`` hold ``payload`` (a checkpoint's)
    bit for bit: every state_dict tensor, mu, nu and count."""
    state = model.state_dict()
    if sorted(state) != sorted(payload["model"]) or \
            optimizer.count != payload["optimizer"]["count"]:
        return False
    if not all(torch.equal(state[k].cpu(), v)
               for k, v in payload["model"].items()):
        return False
    names = {id(p): n for n, p in model.named_parameters()}
    for i, p in enumerate(optimizer.params):
        n = names[id(p)]
        if not (torch.equal(optimizer.mu[i].cpu(), payload["optimizer"]["mu"][n])
                and torch.equal(optimizer.nu[i].cpu(),
                                payload["optimizer"]["nu"][n])):
            return False
    return True


def loop_overrides(cfg, ckpt_dir, epochs, resume="", samples=LOOP_SAMPLES):
    return {"train_dataset.cfg_list": [dict(cfg.train_dataset.cfg_list[0],
                                            length=samples)],
            "val_dataset.length": LOOP_VAL, "trainer.max_epochs": epochs,
            "trainer.disp_iter": 1, "path.checkpoint_path": str(ckpt_dir),
            "path.pretrained_checkpoint": resume}


def train_loop_phase(counters, record):
    """Phase 40: the flagship recipe trained from its dataset through the
    port's ``train.main`` (``configs/synthetic_flagship.py``: bf16, bs12
    @192x640, 4 loader workers, 36 samples, 2 epochs), then resumed from
    ``_latest`` for one more epoch; ``test.main`` on that checkpoint."""
    import shutil

    from fsnet_tpu_torch.runtime.checkpoint import load_checkpoint
    from fsnet_tpu_torch.scripts import test as test_script
    from fsnet_tpu_torch.scripts import train as train_script
    from fsnet_tpu_torch.utils import cfg_from_file

    cfg = cfg_from_file(str(FLAGSHIP_CONFIG))
    shutil.rmtree(LOOP_DIR, ignore_errors=True)
    want = record["bf16_steps"]["grid"]
    steps_per_epoch = LOOP_SAMPLES // cfg.data.batch_size
    watch = LoopWatch(counters)
    runs = {}
    try:
        t0 = time.perf_counter()
        runs["first"] = train_script.main(
            config=str(FLAGSHIP_CONFIG), device="cuda",
            **loop_overrides(cfg, LOOP_DIR / "a", LOOP_EPOCHS))
        first_s = time.perf_counter() - t0
        latest = runs["first"]["checkpoint"]
        saved = load_checkpoint(latest)
        check(restored_bitwise(runs["first"]["model"],
                               runs["first"]["optimizer"], saved),
              "phase 40: _latest differs from the trained model")
        first_steps = len(watch.steps)
        watch.expect = saved
        t0 = time.perf_counter()
        runs["resumed"] = train_script.main(
            config=str(FLAGSHIP_CONFIG), device="cuda",
            **loop_overrides(cfg, LOOP_DIR / "b", LOOP_EPOCHS + 1, latest))
        resumed_s = time.perf_counter() - t0
    finally:
        watch.close()
    n_steps = (LOOP_EPOCHS + 1) * steps_per_epoch
    check(len(watch.steps) == n_steps and first_steps == LOOP_EPOCHS
          * steps_per_epoch, f"phase 40: {len(watch.steps)} steps, "
          f"{first_steps} before the resume")
    for i, s in enumerate(watch.steps):
        check(s["launches"] == want["launches"], f"phase 40 step {i}: "
              f"launches {s['launches']}, phase 33's {want['launches']}")
        check(all(s["dtypes"][k] == v for k, v in want["dtypes"].items()),
              f"phase 40 step {i}: launches by dtype {s['dtypes']}")
        check(s["routes"] == want["routes"], f"phase 40 step {i}: routes "
              f"{s['routes']}, phase 33's {want['routes']}")
    losses = [e["loss"] for r in runs.values() for e in r["log"]]
    check(len(losses) == n_steps and all(np.isfinite(losses)),
          f"phase 40: losses {losses}")
    check(len(watch.noise) == n_steps and all(
        not torch.equal(a, b) for i, a in enumerate(watch.noise)
        for b in watch.noise[i + 1:]), "phase 40: the noise repeated")
    check(watch.restored is True, "phase 40: the resumed model and "
          "optimizer differ from _latest")
    resumed = runs["resumed"]
    count0, lr0 = watch.lrs[first_steps]
    check(count0 == saved["optimizer"]["count"] == first_steps
          and lr0 == resumed["schedule"](count0),
          f"phase 40: resumed at count {count0}, lr {lr0}")
    check(resumed["epoch"] == LOOP_EPOCHS + 1
          and resumed["global_step"] == n_steps,
          f"phase 40: resumed run ended at epoch {resumed['epoch']}, step "
          f"{resumed['global_step']}")

    # test.main on the resumed run's checkpoint
    head = cfg.meta_arch.head_cfg
    zero(counters)
    ev = test_script.main(config=str(FLAGSHIP_CONFIG),
                          checkpoint=resumed["checkpoint"], device="cuda",
                          **{"val_dataset.length": LOOP_VAL})
    torch.cuda.synchronize()
    ev_counts = read(counters)
    check(ev_counts == dict(dict.fromkeys(ev_counts, 0),
                            conv3x3=len(SHAPES) * LOOP_VAL),
          f"phase 40: test.main launched {ev_counts}")
    check(ev["samples"] == LOOP_VAL and ev["epoch"] == LOOP_EPOCHS + 1
          and np.isfinite([ev["min"], ev["mean"], ev["max"]]).all()
          and head.min_depth <= ev["min"] and ev["max"] <= head.max_depth,
          f"phase 40: evaluation {ev}")
    out = dict(steps=n_steps, losses=losses, launches=want["launches"],
               resumed_count=count0, resumed_lr=lr0, eval=ev,
               first_run_s=first_s, resumed_run_s=resumed_s,
               log=[dict(e, run=name) for name, r in runs.items()
                    for e in r["log"]])
    print(f"phase 40: train.main on {FLAGSHIP_CONFIG.name} (bf16 bs"
          f"{cfg.data.batch_size}@{cfg.data.rgb_shape[0]}x"
          f"{cfg.data.rgb_shape[1]}, {cfg.data.num_workers} workers): "
          f"{n_steps} steps, losses {[round(x, 6) for x in losses]}, "
          f"launches per step {want['launches']} (phase 33's grid step), "
          f"fresh noise each step, _latest reloaded bitwise, resumed at "
          f"count {count0} lr {lr0:.3e}; test.main over {LOOP_VAL} val "
          f"samples: {ev_counts['conv3x3']} conv3x3 launches, depth "
          f"[{ev['min']:.3f}, {ev['max']:.3f}]; runs {first_s:.1f} s and "
          f"{resumed_s:.1f} s")
    return out


# phase 41: one epoch long enough that the wait at its start (one worker
# makes the first batch alone, the loader drains at each epoch's end) is
# paid once: RATE_BATCHES batches, the steady pace read over the last
# RATE_STEADY; dataset[i] timed over RATE_SAMPLES samples
RATE_BATCHES, RATE_STEADY, RATE_SAMPLES = 10, 6, 6


def sample_ms(config=FLAGSHIP_CONFIG, samples=RATE_SAMPLES) -> float:
    """``dataset[i]`` of ``config``'s train dataset (rendering and the
    augmentation graph) in one process: ms a sample, the mean over
    ``samples`` after one call that is not timed."""
    from fsnet_tpu_torch.utils import build, cfg_from_file

    cfg = cfg_from_file(str(config))
    cfg.train_dataset.cfg_list[0].length = samples + 1
    dataset = build(**cfg.train_dataset)
    dataset[samples]
    t0 = time.perf_counter()
    for i in range(samples):
        dataset[i]
    return (time.perf_counter() - t0) / samples * 1e3


def loop_readings(record, loop):
    """Phase 41, readings only: ``dataset[i]`` alone (one process, ms a
    sample); the loader alone (4 workers, one epoch of 10 batches, ms a
    batch over the last 6); the loop, ``train.main`` over one epoch of 10
    steps: its step wall, loader wait and imgs/s over the last 6 steps,
    and its first step apart (the epoch-boundary reading, as are phase
    40's epochs of 3 steps); and phase 35's grid-route bf16 step with the
    batch on the card."""
    from fsnet_tpu_torch.data.dataloader import build_dataloader
    from fsnet_tpu_torch.scripts import train as train_script
    from fsnet_tpu_torch.utils import build, cfg_from_file

    sample = sample_ms()
    cfg = cfg_from_file(str(FLAGSHIP_CONFIG))
    bs = cfg.data.batch_size
    cfg.train_dataset.cfg_list[0].length = RATE_BATCHES * bs
    dataset = build(**cfg.train_dataset)

    warm = RATE_BATCHES - RATE_STEADY
    loader = build_dataloader(dataset, num_workers=cfg.data.num_workers,
                              batch_size=bs, pin_memory=True)
    try:
        it = iter(loader)
        t0 = time.perf_counter()
        for _ in range(warm):
            next(it)
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        check(sum(1 for _ in it) == RATE_STEADY, "phase 41: the epoch is "
              f"not {RATE_BATCHES} batches")
        loader_ms = (time.perf_counter() - t0) / RATE_STEADY * 1e3
    finally:
        loader.close()

    run = train_script.main(
        config=str(FLAGSHIP_CONFIG), device="cuda",
        **loop_overrides(cfg, LOOP_DIR / "rate", 1,
                         samples=RATE_BATCHES * bs))
    log = run["log"]
    check(len(log) == RATE_BATCHES and all(np.isfinite([e["loss"]
                                                        for e in log])),
          f"phase 41: {len(log)} steps, losses {[e['loss'] for e in log]}")
    wall = float(np.mean([e["wall_ms"] for e in log[warm:]]))
    wait = float(np.mean([e["wait_ms"] for e in log[warm:]]))
    # phase 40's epochs of 3 steps: epoch-boundary readings
    epochs = {}
    for e in loop["log"]:
        epochs.setdefault((e["run"], e["epoch"]), []).append(e)
    per_epoch = [dict(run=r, epoch=ep,
                      wall_ms=float(np.mean([e["wall_ms"] for e in es])),
                      wait_ms=float(np.mean([e["wait_ms"] for e in es])))
                 for (r, ep), es in epochs.items()]
    on_card = record["bf16_train_step"]["grid_bf16"]
    out = dict(card=record["card"], sample_ms=sample,
               loader_ms_per_batch=loader_ms, loader_first_s=warm_s,
               loop_wall_ms=wall, loop_wait_ms=wait,
               loop_imgs_per_s=bs / wall * 1e3,
               first_step_wall_ms=log[0]["wall_ms"],
               first_step_wait_ms=log[0]["wait_ms"],
               walls_ms=[e["wall_ms"] for e in log],
               waits_ms=[e["wait_ms"] for e in log],
               epoch_boundary=per_epoch,
               batch_on_card_ms=on_card["ms"],
               batch_on_card_imgs_per_s=on_card["imgs_per_s"])
    print(f"phase 41 ({record['card']}): dataset[i] {sample:.1f} ms a "
          f"sample (one process); loader alone {loader_ms:.1f} ms a batch "
          f"of {bs} ({cfg.data.num_workers} workers, last {RATE_STEADY} of "
          f"{RATE_BATCHES}; first {warm} in {warm_s:.1f} s); the loop over "
          f"the last {RATE_STEADY} of {RATE_BATCHES} steps: step wall "
          f"{wall:.1f} ms = {bs / wall * 1e3:.2f} imgs/s, loader wait "
          f"{wait:.1f} ms; its first step (the epoch boundary) "
          f"{log[0]['wall_ms']:.1f} ms, {log[0]['wait_ms']:.1f} ms of it "
          f"waiting; phase 35's grid bf16 step, batch on the card: "
          f"{on_card['ms']:.3f} ms = {on_card['imgs_per_s']:.2f} imgs/s")
    return out


# phases 42-43: the KITTI raw recipe from a PNG tree written on disk
ROOT = Path(__file__).resolve().parent
KITTI_CONFIG = ROOT / "fsnet_tpu_torch" / "configs" / "kitti_wpose_example.py"
DISK_DIR = ROOT / "build" / "disk_tree"
KITTI_H, KITTI_W = 375, 1242
DISK_DATE = "2011_09_26"
DISK_TRAIN = f"{DISK_DATE}/{DISK_DATE}_drive_0001_sync"
DISK_TEST = f"{DISK_DATE}/{DISK_DATE}_drive_0002_sync"
# 36 training samples (3 steps of 12), 24 Eigen-style test frames;
# dataset[i] timed over DISK_SAMPLES samples a run, two runs of each tree
DISK_STEPS, DISK_EVAL, DISK_SAMPLES, READ_REPEATS = 3, 24, 4, 20


def disk_trees():
    """The tree writers of ``tests/disk_trees.py`` (numpy, zlib and
    scipy.io only)."""
    sys.path.insert(0, str(ROOT / "tests"))
    import disk_trees

    return disk_trees


def write_disk_tree(dt, batch):
    """A KITTI raw tree at 375x1242 under ``build/disk_tree``: one date with
    KITTI's calibration; a training drive of 36 samples (frames 1-36 of 38,
    both cameras, sides alternating) and a test drive of 24 frames with
    velodyne scans; the two split files. Returns the paths and the
    seconds it took."""
    import shutil

    shutil.rmtree(DISK_DIR, ignore_errors=True)
    raw = DISK_DIR / "raw"
    t0 = time.perf_counter()
    dt.write_kitti_date(str(raw / DISK_DATE), KITTI_H, KITTI_W)
    n_train = DISK_STEPS * batch
    dt.write_kitti_drive(str(raw), DISK_TRAIN, n_train + 2, KITTI_H, KITTI_W,
                         seed=1)
    dt.write_kitti_drive(str(raw), DISK_TEST, DISK_EVAL + 1, KITTI_H,
                         KITTI_W, seed=2, cams=("image_02",), velodyne=True)
    train = dt.write_split(DISK_DIR / "train_files.txt", [
        f"{DISK_TRAIN} {i} {'lr'[i % 2]}" for i in range(1, n_train + 1)])
    test = dt.write_split(DISK_DIR / "test_files.txt", [
        f"{DISK_TEST} {i} l" for i in range(1, DISK_EVAL + 1)])
    return dict(raw=str(raw), train=train, test=test,
                gt=str(DISK_DIR / "gt_depths.npz"),
                seconds=time.perf_counter() - t0)


def disk_overrides(tree, ckpt_dir, **extra):
    """``kitti_wpose_example.py`` pointed at the written tree: its paths and
    split files, the ground truth in the tree, an evaluation after every
    epoch of one, the encoder from seeded random weights (no ImageNet file
    on the machine) and the evaluation loader in-process (the training
    loader's workers are the run's only ones)."""
    ev = "trainer.evaluate_hook."
    return {"train_dataset.cfg_list": [dict(
                name="fsnet_tpu_torch.data.datasets.mono_dataset."
                     "KittiDepthMonoDataset",
                raw_path=tree["raw"], split_file=tree["train"])],
            "val_dataset.raw_path": tree["raw"],
            "val_dataset.split_file": tree["test"],
            ev + "dataset_eval_cfg.data_path": tree["raw"],
            ev + "dataset_eval_cfg.split_file": tree["test"],
            ev + "dataset_eval_cfg.gt_saved_file": tree["gt"],
            ev + "num_workers": 0,
            "meta_arch.depth_backbone_cfg.pretrained": False,
            "trainer.max_epochs": 1, "trainer.test_iter": 1,
            "trainer.disp_iter": 1, "path.checkpoint_path": str(ckpt_dir),
            **extra}


def disk_sample_ms(tree, samples=DISK_SAMPLES) -> float:
    """``dataset[i]`` of the recipe's train dataset on the written tree
    (three PNG reads and the flagship's train augmentation) in one process:
    ms a sample, the mean over the first ``samples`` after one call on the
    last, not timed."""
    from fsnet_tpu_torch.utils import build, cfg_from_file, update_cfg

    cfg = update_cfg(cfg_from_file(str(KITTI_CONFIG)),
                     **disk_overrides(tree, DISK_DIR / "unused"))
    dataset = build(**cfg.train_dataset)
    dataset[len(dataset) - 1]
    t0 = time.perf_counter()
    for i in range(samples):
        dataset[i]
    return (time.perf_counter() - t0) / samples * 1e3


def reader_phase(record):
    """Phase 42: the port's PNG reader on the card machine. The C unfilter
    (built here by ``cc``) bitwise equal to the plain version, and both to
    the written samples, on 375x1242 8-bit RGB, 8-bit grey, 16-bit grey
    and 16-bit RGB files whose rows cycle through the five filters, and on
    the repo's ``fisheye_mask.png`` (every row Sub); readings: the build,
    one RGB frame and one 16-bit depth map read, ``dataset[i]`` of the
    written KITTI raw tree beside ``sample_ms`` of the synthetic render,
    alternated."""
    import shutil

    from fsnet_tpu_torch.data.datasets import image_io
    from fsnet_tpu_torch.data.datasets.io_utils import read_depth, read_image

    dt = disk_trees()
    t0 = time.perf_counter()
    image_io._library()
    build_s = time.perf_counter() - t0
    files = DISK_DIR / "reader"
    shutil.rmtree(files, ignore_errors=True)
    files.mkdir(parents=True)
    rng = np.random.RandomState(42)
    samples = {
        "rgb8": dt.texture(KITTI_H, KITTI_W, 0.0, 7),
        "grey8": dt.texture(KITTI_H, KITTI_W, 3.0, 8)[..., 1],
        "grey16": dt.sparse_depth_png(KITTI_H, KITTI_W, 9),
        "rgb16": rng.randint(0, 65536, (KITTI_H, KITTI_W, 3)
                             ).astype(np.uint16)}
    paths = {}
    for name, img in samples.items():
        paths[name] = files / f"{name}.png"
        dt.write_png(paths[name], img)
    paths["fisheye_mask"] = (ROOT / "meta_data" / "kitti360_trainsub"
                             / "fisheye_mask.png")
    checked = {}
    for name, path in paths.items():
        got = image_io.read_png(str(path))
        ref = image_io.read_png(str(path), plain=True)
        check(got.dtype == ref.dtype and np.array_equal(got, ref),
              f"phase 42: the C unfilter differs from the plain version on "
              f"{name}")
        if name in samples:
            check(np.array_equal(got, samples[name]),
                  f"phase 42: {name} read back differs from what was "
                  "written")
        checked[name] = f"{got.shape} {got.dtype}"
    check(paths["fisheye_mask"].exists() and checked["fisheye_mask"]
          == "(700, 700) uint8", f"phase 42: fisheye mask {checked}")

    def read_ms(fn, path):
        fn(str(path))
        t0 = time.perf_counter()
        for _ in range(READ_REPEATS):
            fn(str(path))
        return (time.perf_counter() - t0) / READ_REPEATS * 1e3

    rgb_ms = read_ms(read_image, paths["rgb8"])
    depth_ms = read_ms(read_depth, paths["grey16"])
    from fsnet_tpu_torch.utils import cfg_from_file

    tree = write_disk_tree(dt, cfg_from_file(str(KITTI_CONFIG)
                                             ).data.batch_size)
    synth, disk = [], []
    for _ in range(2):               # in turns: synthetic, disk, ...
        synth.append(sample_ms(samples=DISK_SAMPLES))
        disk.append(disk_sample_ms(tree, DISK_SAMPLES))
    out = dict(card=record["card"], cc_build_s=build_s, files=checked,
               read_rgb_ms=rgb_ms, read_depth16_ms=depth_ms,
               tree_write_s=tree["seconds"], disk_sample_ms=disk,
               synthetic_sample_ms=synth, tree=tree)
    print(f"phase 42 ({record['card']}): the C unfilter bitwise equal to "
          f"the plain version and to the written samples on {checked}; cc "
          f"build {build_s:.2f} s; read one 375x1242 RGB PNG "
          f"{rgb_ms:.2f} ms, one 16-bit depth PNG {depth_ms:.2f} ms; "
          f"dataset[i] from the written KITTI raw tree "
          f"{', '.join(f'{v:.1f}' for v in disk)} ms a sample against the "
          f"synthetic render's {', '.join(f'{v:.1f}' for v in synth)} "
          f"(alternated, {DISK_SAMPLES} samples each); tree written in "
          f"{tree['seconds']:.1f} s")
    return out


class EvalWatch:
    """Wraps the validation hook for phase 43: the launch counters set to 0
    just before each evaluation forward and read just after."""

    def __init__(self, counters):
        from fsnet_tpu_torch.pipeline_hooks import train_val_hooks as hooks

        self.hooks, self.forwards = hooks, []
        self.saved = call = hooks.BaseValidationHook.__call__
        watch = self

        def counted(hook, data, model, *args, **kw):
            zero(counters)
            out = call(hook, data, model, *args, **kw)
            torch.cuda.synchronize()
            watch.forwards.append(read(counters))
            return out

        hooks.BaseValidationHook.__call__ = counted

    def close(self):
        self.hooks.BaseValidationHook.__call__ = self.saved


def rel_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def disk_recipe_phase(counters, record, tree):
    """Phase 43: ``train.main`` on the port's ``kitti_wpose_example.py``
    pointed at the written tree (bf16, bs12 @192x640, 4 loader workers, one
    epoch of 3 steps, then the evaluation of 24 frames through
    ``KittiEvaluationHook`` and ``KittiEigenEvaluator``, the ground truth
    precomputed first); ``test.main`` on the saved checkpoint on the card
    and on the CPU."""
    from fsnet_tpu_torch.evaluation.kitti_unsupervised_eval import \
        KittiEigenEvaluator
    from fsnet_tpu_torch.scripts import test as test_script
    from fsnet_tpu_torch.scripts import train as train_script
    from fsnet_tpu_torch.utils import cfg_from_file, update_cfg

    t0 = time.perf_counter()
    gt = KittiEigenEvaluator(tree["raw"], tree["test"], tree["gt"])
    gt_s = time.perf_counter() - t0
    check(len(gt.gt_depths) == DISK_EVAL and all(
        d.shape == (KITTI_H, KITTI_W) and (d > 0).sum() > 1000
        for d in gt.gt_depths), "phase 43: ground truth "
        f"{[(d.shape, int((d > 0).sum())) for d in gt.gt_depths]}")
    want = record["bf16_steps"]["grid"]
    over = disk_overrides(tree, DISK_DIR / "ckpt")
    loop, ev_watch = LoopWatch(counters), EvalWatch(counters)
    try:
        t0 = time.perf_counter()
        run = train_script.main(config=str(KITTI_CONFIG), device="cuda",
                                **over)
        run_s = time.perf_counter() - t0
    finally:
        loop.close()
        ev_watch.close()
    check(len(loop.steps) == DISK_STEPS and run["global_step"]
          == DISK_STEPS, f"phase 43: {len(loop.steps)} steps")
    for i, s in enumerate(loop.steps):
        check(s["launches"] == want["launches"], f"phase 43 step {i}: "
              f"launches {s['launches']}, phase 33's {want['launches']}")
        check(all(s["dtypes"][k] == v for k, v in want["dtypes"].items()),
              f"phase 43 step {i}: launches by dtype {s['dtypes']}")
        check(s["routes"] == want["routes"], f"phase 43 step {i}: routes "
              f"{s['routes']}, phase 33's {want['routes']}")
    losses = [e["loss"] for e in run["log"]]
    check(len(losses) == DISK_STEPS and all(np.isfinite(losses)),
          f"phase 43: losses {losses}")
    one = dict(dict.fromkeys(ev_watch.forwards[0], 0), conv3x3=len(SHAPES))
    check(len(ev_watch.forwards) == DISK_EVAL
          and all(f == one for f in ev_watch.forwards),
          f"phase 43: {len(ev_watch.forwards)} evaluation forwards, "
          f"launches {ev_watch.forwards[:2]}")
    check(len(run["evals"]) == 1, f"phase 43: {len(run['evals'])} "
          "evaluations")
    ev = run["evals"][0]
    check(all(np.isfinite(ev[k]).all() and ev[k].shape == (7,)
              for k in ("errors", "abs_errors")), f"phase 43: {ev}")

    t0 = time.perf_counter()
    card = test_script.main(config=str(KITTI_CONFIG),
                            checkpoint=run["checkpoint"], device="cuda",
                            **over)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = test_script.main(config=str(KITTI_CONFIG),
                           checkpoint=run["checkpoint"], device="cpu", **over)
    cpu_s = time.perf_counter() - t0
    same = max(rel_max(card[k], ev[k]) for k in ("errors", "abs_errors"))
    check(card["samples"] == DISK_EVAL and same <= 1e-6,
          f"phase 43: test.main {card} against the loop's evaluation {ev}")
    # the continuous metrics (abs_rel, sq_rel, rmse, rmse_log): phase 6's
    # depth gate
    vs_cpu = max(rel_max(card[k][:4], cpu[k][:4])
                 for k in ("errors", "abs_errors"))
    a_vs_cpu = max(float(np.abs(card[k][4:] - cpu[k][4:]).max())
                   for k in ("errors", "abs_errors"))
    check(vs_cpu <= 1e-3, f"phase 43: card vs CPU metrics rel {vs_cpu:.3e}"
          f" > 1e-3: card {card}, CPU {cpu}")
    log = run["log"]
    out = dict(card=record["card"], gt_precompute_s=gt_s, run_s=run_s,
               losses=losses, launches=want["launches"],
               eval_launches_per_frame=one,
               errors=ev["errors"].tolist(),
               abs_errors=ev["abs_errors"].tolist(),
               eval_s=ev["seconds"],
               eval_frames_per_s=DISK_EVAL / ev["seconds"],
               test_main_card_s=card_s, test_main_cpu_s=cpu_s,
               test_main_vs_loop_rel=same, card_vs_cpu_rel=vs_cpu,
               card_vs_cpu_a_abs=a_vs_cpu,
               walls_ms=[e["wall_ms"] for e in log],
               waits_ms=[e["wait_ms"] for e in log])
    cfg = update_cfg(cfg_from_file(str(KITTI_CONFIG)), **over)
    print(f"phase 43 ({record['card']}): train.main on "
          f"{KITTI_CONFIG.name} from the written tree "
          f"({cfg.trainer.training_hook.compute_dtype} bs"
          f"{cfg.data.batch_size}@{cfg.data.rgb_shape[0]}x"
          f"{cfg.data.rgb_shape[1]}, {cfg.data.num_workers} workers): "
          f"{DISK_STEPS} steps, losses "
          f"{[round(x, 6) for x in losses]}, launches per step phase 33's "
          f"grid step; step walls {[round(v, 1) for v in out['walls_ms']]} "
          f"ms, loader waits {[round(v, 1) for v in out['waits_ms']]} ms; "
          f"evaluation of {DISK_EVAL} frames, {one['conv3x3']} conv3x3 "
          f"launches each and nothing else, {ev['seconds']:.2f} s = "
          f"{out['eval_frames_per_s']:.2f} frames/s; abs_rel "
          f"{ev['errors'][0]:.4f} (scaled) {ev['abs_errors'][0]:.4f} "
          f"(absolute); test.main on the card equal to the loop's within "
          f"{same:.1e}, against the CPU port's {vs_cpu:.2e} rel (a1-a3 "
          f"{a_vs_cpu:.2e}); ground truth precomputed in {gt_s:.2f} s; "
          f"run {run_s:.1f} s, test.main {card_s:.1f} s card, {cpu_s:.1f} "
          "s CPU")
    return out


# phases 44-46: the nuScenes recipes from a JPEG tree written on disk
NUSC_CONFIG = ROOT / "fsnet_tpu_torch" / "configs" / "nusc_wpose_example.py"
DISTILL_CONFIG = (ROOT / "fsnet_tpu_torch" / "configs"
                  / "distill_nusc_example.py")
NUSC_DIR = ROOT / "build" / "nusc_tree"
NUSC_FRAME_H, NUSC_FRAME_W = 900, 1600
# 24 training samples (3 steps of 8, CAM_FRONT and CAM_BACK in turn), 8
# val frames; dataset[i] timed over NUSC_SAMPLES samples a run, two runs
NUSC_STEPS, NUSC_VAL, NUSC_SAMPLES = 3, 8, 3
# phase 44's files: name -> (H, W, subsampling, quality, restart interval)
JPEG_FILES = {
    "420": (900, 1600, "4:2:0", 90, 0),
    "422": (900, 1600, "4:2:2", 90, 0),
    "444": (900, 1600, "4:4:4", 90, 0),
    "grey": (900, 1600, "grey", 90, 0),
    "odd_420_rst": (451, 803, "4:2:0", 75, 7),
}
# sha256 of each file as tests/disk_trees.write_jpeg writes it, and of
# np.array(PIL.Image.open(file)) (C order), both recorded on a machine with
# PIL (Pillow 12.1.0, libjpeg-turbo); the card machine has no PIL
JPEG_DIGESTS = {
    "420": ("8397e3046dbd848640774a51e37db2643c31143e48a23fff94571aebbee71e1d",
            "3a6366ba4bfcd20b3be2b193961031d22ad4fbbbc188566f8fbff50a6582cf75"),
    "422": ("3ea0b2780746ae857aa77261cb6b2198248fc1abfe656cbffe0eb36f1f925638",
            "1cd93409ecd39fb623c9f3d1ac991119b99001cd6d14ac177c95fb59c6718b0a"),
    "444": ("fe7d2da14db2c4b6b328cccca63ffc1e2be0bd6c05a35b96cacb86fa5f192373",
            "5e50c1be3eba4525a7e79a6f03db86f495d03620b813f06b809a74843449291e"),
    "grey": ("a0995ba0e38d5e40217f624cd9ba186e31fa12c4a391abfcc6621ec6416d55e2",
             "58506a3be1a188951e374710f54ecfd688d1496d608cf0e5d059d361e7cc56fe"),
    "odd_420_rst": (
        "2de025213f317260e15c7f5a66763fd6409710cb3e6311f5bc99f1dd336b1980",
        "efe76646e9137e5e7e52128fc8dd117e3046048e58f6fa58eafb32289607c62f"),
}


def jpeg_sample_image(H, W, seed, grey=False):
    """An [H, W, 3] (or [H, W]) ``uint8`` frame made in integers only, so
    that it and the JPEG written from it are the same bytes on every
    machine: ramps that wrap (sharp edges), 8x8 blocks, seeded noise."""
    y, x = np.mgrid[0:H, 0:W]
    base = np.stack([(3 * x + y) % 256, (x // 8 * 37 + y // 8 * 91) % 256,
                     255 - (x + 2 * y) % 256], -1)
    noise = np.random.RandomState(seed).randint(-16, 17, (H, W, 3))
    img = np.clip(base + noise, 0, 255).astype(np.uint8)
    return img[..., 0].copy() if grey else img


def write_jpeg_files(dt, out_dir):
    """Phase 44's files under ``out_dir``: name -> path."""
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for i, (name, (H, W, sub, quality, restart)) in enumerate(
            JPEG_FILES.items()):
        grey = sub == "grey"
        paths[name] = out_dir / f"{name}.jpg"
        dt.write_jpeg(paths[name], jpeg_sample_image(H, W, 60 + i, grey),
                      quality, "4:2:0" if grey else sub, restart)
    return paths


def sha256(data) -> str:
    import hashlib

    return hashlib.sha256(data).hexdigest()


def write_nusc_tree(dt, batch):
    """The nuScenes tree of phases 44-46 under ``build/nusc_tree``: 900x1600
    JPEG frames (4:2:0, quality 90) of CAM_FRONT and CAM_BACK, 24 training
    samples and 8 val samples in JSON, the val frames' 16-bit ground truth
    from ``generate_depth_map`` of seeded scans. Returns the paths and
    the seconds it took."""
    import shutil

    from fsnet_tpu_torch.evaluation.nuscenes_unsupervised_eval import \
        generate_depth_map

    shutil.rmtree(NUSC_DIR / "tree", ignore_errors=True)
    t0 = time.perf_counter()
    tree = dt.write_nusc_json_tree(
        NUSC_DIR / "tree", NUSC_FRAME_H, NUSC_FRAME_W, NUSC_STEPS * batch,
        NUSC_VAL, seed=3, depth_map=generate_depth_map)
    tree["seconds"] = time.perf_counter() - t0
    return tree


def nusc_overrides(tree, ckpt_dir, **extra):
    """A nuScenes config pointed at the written tree: its JSON files, the
    evaluator's split and ground truth in the tree, one epoch evaluated
    after it, the encoder from seeded random weights (no ImageNet file on
    the machine) and the evaluation loader in-process."""
    ev = "trainer.evaluate_hook."
    return {"train_dataset.cfg_list": [dict(
                name="fsnet_tpu_torch.data.datasets.nuscene_dataset."
                     "NusceneJsonDataset", json_path=tree["train"])],
            "val_dataset.json_path": tree["val"],
            ev + "dataset_eval_cfg.split_file": tree["split"],
            ev + "dataset_eval_cfg.gt_saved_dir": tree["gt"],
            ev + "num_workers": 0,
            "meta_arch.depth_backbone_cfg.pretrained": False,
            "trainer.max_epochs": 1, "trainer.test_iter": 1,
            "trainer.disp_iter": 1, "path.checkpoint_path": str(ckpt_dir),
            **extra}


def nusc_sample_ms(tree, samples=NUSC_SAMPLES) -> float:
    """``dataset[i]`` of ``nusc_wpose_example.py``'s train dataset on the
    written tree (three JPEG decodes and the recipe's train augmentation
    to 288x512) in one process: ms a sample, the mean over the first
    ``samples`` after one call on the last, not timed."""
    from fsnet_tpu_torch.utils import build, cfg_from_file, update_cfg

    cfg = update_cfg(cfg_from_file(str(NUSC_CONFIG)),
                     **nusc_overrides(tree, NUSC_DIR / "unused"))
    dataset = build(**cfg.train_dataset)
    dataset[len(dataset) - 1]
    t0 = time.perf_counter()
    for i in range(samples):
        dataset[i]
    return (time.perf_counter() - t0) / samples * 1e3


def jpeg_phase(record):
    """Phase 44: the port's JPEG reader on the card machine. The C decoder
    (built here by ``cc``) on files written by ``tests/disk_trees.py``
    (900x1600 at 4:2:0, 4:2:2, 4:4:4 and grey, and a 451x803 4:2:0 file
    with a restart interval of 7 MCUs): each file's sha256 the one recorded
    where it was first written, the decode's sha256 that of PIL's decode
    recorded there, and the decode bitwise equal to ``decode_plain`` on the
    C decoder's coefficients; a progressive header refused. Readings: the
    build, one 900x1600 4:2:0 frame's decode, the nuScenes tree's writing
    and ``dataset[i]`` of it beside ``sample_ms`` of the synthetic render,
    in turns."""
    from fsnet_tpu_torch.data.datasets import image_io
    from fsnet_tpu_torch.utils import cfg_from_file

    dt = disk_trees()
    t0 = time.perf_counter()
    image_io._library(image_io.JPEG_SOURCE)
    build_s = time.perf_counter() - t0
    paths = write_jpeg_files(dt, NUSC_DIR / "jpeg")
    checked = {}
    for name, path in paths.items():
        file_sha, pil_sha = JPEG_DIGESTS[name]
        check(sha256(path.read_bytes()) == file_sha,
              f"phase 44: {name}: the written file differs from the one "
              "whose PIL decode was recorded")
        H, W, sub = JPEG_FILES[name][:3]
        got = image_io.read_jpeg(str(path))
        check(got.shape == ((H, W) if sub == "grey" else (H, W, 3))
              and got.dtype == np.uint8, f"phase 44: {name}: {got.shape} "
              f"{got.dtype}")
        check(sha256(np.ascontiguousarray(got).tobytes()) == pil_sha,
              f"phase 44: {name}: the C decode differs from PIL's")
        plain = image_io.read_jpeg(str(path), plain=True)
        check(np.array_equal(plain, got), f"phase 44: {name}: the C decode "
              "differs from decode_plain")
        checked[name] = f"{got.shape} {sub}"
    blob = bytearray(paths["420"].read_bytes())
    sof = blob.index(b"\xff\xc0")
    blob[sof + 1] = 0xC2
    progressive = NUSC_DIR / "jpeg" / "progressive.jpg"
    progressive.write_bytes(bytes(blob))
    try:
        image_io.read_jpeg(str(progressive))
        refused = None
    except image_io.JPEGError as e:
        refused = str(e)
    check(refused is not None and "progressive" in refused
          and str(progressive) in refused,
          f"phase 44: a progressive header was not refused: {refused}")

    image_io.read_jpeg(str(paths["420"]))
    t0 = time.perf_counter()
    for _ in range(READ_REPEATS):
        image_io.read_jpeg(str(paths["420"]))
    decode_ms = (time.perf_counter() - t0) / READ_REPEATS * 1e3
    tree = write_nusc_tree(dt, cfg_from_file(str(NUSC_CONFIG)
                                             ).data.batch_size)
    synth, disk = [], []
    for _ in range(2):               # in turns: synthetic, JPEG tree, ...
        synth.append(sample_ms(samples=NUSC_SAMPLES))
        disk.append(nusc_sample_ms(tree))
    out = dict(card=record["card"], cc_build_s=build_s, files=checked,
               decode_420_ms=decode_ms, tree_write_s=tree["seconds"],
               nusc_sample_ms=disk, synthetic_sample_ms=synth, tree=tree)
    print(f"phase 44 ({record['card']}): the C JPEG decoder equal to PIL's "
          f"recorded decode and to decode_plain on {checked}; a "
          f"progressive header refused; cc build {build_s:.2f} s; decode "
          f"one 900x1600 4:2:0 frame {decode_ms:.2f} ms; dataset[i] from "
          f"the written nuScenes tree "
          f"{', '.join(f'{v:.1f}' for v in disk)} ms a sample against the "
          f"synthetic render's {', '.join(f'{v:.1f}' for v in synth)} "
          f"(alternated, {NUSC_SAMPLES} samples each); tree written in "
          f"{tree['seconds']:.1f} s")
    return out


def back_mask_rows(batch):
    """For each CAM_BACK sample of a step's batch: the first output row
    whose source row (through the warp that ``P2`` records against
    ``original_P2``) is 700 or below, and whether every row from one past
    it is 0 in ``patched_mask`` while some row above it is not."""
    out = []
    for i, cam in enumerate(batch["camera_type"]):
        if cam != "CAM_BACK":
            continue
        P2 = batch["P2"][i].double().numpy()
        P0 = batch["original_P2"][i].double().numpy()
        scale = P2[1, 1] / P0[1, 1]
        row = scale * 699.5 + (P2[1, 2] - scale * P0[1, 2])
        mask = batch["patched_mask"][i].numpy()
        start = max(int(np.ceil(row)) + 1, 0)
        ok = (not mask[start:].any()
              and (start == 0 or mask[:max(int(row) - 1, 0)].any()))
        out.append(dict(row=float(row), ok=bool(ok),
                        visible=bool(start < mask.shape[0])))
    return out


def nusc_loop(counters, config, tree, want, what, teacher=None):
    """``train.main`` on ``config`` pointed at the written tree (one epoch
    of 3 steps, then the evaluation of 8 frames), each step and each
    evaluation forward watched; the checks every nuScenes recipe shares.
    Returns the run, the watches and the seconds."""
    from fsnet_tpu_torch.scripts import train as train_script

    extra = {} if teacher is None else {"meta_arch.teacher_net_path":
                                        str(teacher)}
    over = nusc_overrides(tree, NUSC_DIR / f"ckpt_{what.split()[-1]}",
                          **extra)
    loop = LoopWatch(counters, keep=("camera_type", "patched_mask", "P2",
                                     "original_P2"))
    ev_watch = EvalWatch(counters)
    try:
        t0 = time.perf_counter()
        run = train_script.main(config=str(config), device="cuda", **over)
        run_s = time.perf_counter() - t0
    finally:
        loop.close()
        ev_watch.close()
    check(len(loop.steps) == NUSC_STEPS and run["global_step"]
          == NUSC_STEPS, f"{what}: {len(loop.steps)} steps")
    for i, s in enumerate(loop.steps):
        check(s["launches"] == want["launches"], f"{what} step {i}: "
              f"launches {s['launches']}, phase 37's {want['launches']}")
        check(all(s["dtypes"][k] == v for k, v in want["dtypes"].items()),
              f"{what} step {i}: launches by dtype {s['dtypes']}")
        check(all(s["routes"][k] == v for k, v in want["routes"].items()),
              f"{what} step {i}: routes {s['routes']}, phase 37's "
              f"{want['routes']}")
    losses = [e["loss"] for e in run["log"]]
    check(len(losses) == NUSC_STEPS and all(np.isfinite(losses)),
          f"{what}: losses {losses}")
    check(len(run["evals"]) == 1, f"{what}: {len(run['evals'])} "
          "evaluations")
    ev = run["evals"][0]
    check(sorted(ev["channels"]) == ["CAM_BACK", "CAM_FRONT"]
          and all(np.isfinite(s).all() and s.shape == (7,)
                  for suites in [(ev["errors"], ev["abs_errors"])]
                  + list(ev["channels"].values()) for s in suites),
          f"{what}: evaluation {ev}")
    return run, loop, ev_watch, over, run_s


def nusc_recipe_phase(counters, record, tree):
    """Phase 45: ``train.main`` on the port's ``nusc_wpose_example.py``
    pointed at the written JPEG tree (bf16, bs8 @288x512, 4 loader
    workers, one epoch of 3 steps, then the evaluation of 8 frames through
    ``FastNuscEvaluationHook`` and ``NuscenesEvaluator``); ``test.main`` on
    the saved checkpoint on the card and on the CPU."""
    from fsnet_tpu_torch.scripts import test as test_script
    from fsnet_tpu_torch.utils import cfg_from_file, update_cfg

    want = record["bf16_recipe_steps"]["nusc"]
    run, loop, ev_watch, over, run_s = nusc_loop(
        counters, NUSC_CONFIG, tree, want, "phase 45")
    masks = [m for s in loop.steps for m in back_mask_rows(s["batch"])]
    check(masks and all(m["ok"] for m in masks)
          and any(m["visible"] for m in masks),
          f"phase 45: CAM_BACK masks {masks}")
    one = dict(dict.fromkeys(ev_watch.forwards[0], 0), conv3x3=len(SHAPES))
    check(ev_watch.forwards and all(f == one for f in ev_watch.forwards),
          f"phase 45: evaluation forwards' launches {ev_watch.forwards}")
    ev = run["evals"][0]

    def suites(res):
        out = {"all": (res["errors"], res["abs_errors"])}
        out.update(res["channels"])
        return out

    t0 = time.perf_counter()
    card = test_script.main(config=str(NUSC_CONFIG),
                            checkpoint=run["checkpoint"], device="cuda",
                            **over)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = test_script.main(config=str(NUSC_CONFIG),
                           checkpoint=run["checkpoint"], device="cpu", **over)
    cpu_s = time.perf_counter() - t0
    loop_s, card_r, cpu_r = suites(ev), suites(card), suites(cpu)
    check(sorted(card_r) == sorted(loop_s) == sorted(cpu_r),
          f"phase 45: test.main's cameras {sorted(card_r)}")
    same = max(rel_max(a, b) for k in loop_s
               for a, b in zip(card_r[k], loop_s[k]))
    check(card["samples"] == NUSC_VAL and same <= 1e-6,
          f"phase 45: test.main {card} against the loop's evaluation {ev}")
    # the continuous metrics (abs_rel, sq_rel, rmse, rmse_log): phase 6's
    # depth gate
    vs_cpu = max(rel_max(a[:4], b[:4]) for k in card_r
                 for a, b in zip(card_r[k], cpu_r[k]))
    a_vs_cpu = max(float(np.abs(a[4:] - b[4:]).max()) for k in card_r
                   for a, b in zip(card_r[k], cpu_r[k]))
    check(vs_cpu <= 1e-3, f"phase 45: card vs CPU metrics rel {vs_cpu:.3e}"
          f" > 1e-3: card {card}, CPU {cpu}")
    log = run["log"]
    out = dict(card=record["card"], run_s=run_s, losses=[e["loss"]
                                                         for e in log],
               checkpoint=run["checkpoint"],
               launches=want["launches"], eval_launches_per_forward=one,
               eval_forwards=len(ev_watch.forwards), back_masks=masks,
               errors={k: [s.tolist() for s in v] for k, v in loop_s.items()},
               eval_s=ev["seconds"], eval_frames_per_s=NUSC_VAL
               / ev["seconds"], test_main_card_s=card_s,
               test_main_cpu_s=cpu_s, test_main_vs_loop_rel=same,
               card_vs_cpu_rel=vs_cpu, card_vs_cpu_a_abs=a_vs_cpu,
               walls_ms=[e["wall_ms"] for e in log],
               waits_ms=[e["wait_ms"] for e in log])
    cfg = update_cfg(cfg_from_file(str(NUSC_CONFIG)), **over)
    print(f"phase 45 ({record['card']}): train.main on {NUSC_CONFIG.name} "
          f"from the written JPEG tree "
          f"({cfg.trainer.training_hook.compute_dtype} bs"
          f"{cfg.data.batch_size}@{cfg.data.rgb_shape[0]}x"
          f"{cfg.data.rgb_shape[1]}, {cfg.data.num_workers} workers): "
          f"{NUSC_STEPS} steps, losses "
          f"{[round(x, 6) for x in out['losses']]}, launches per step phase "
          f"37's nusc_wpose bf16 step; {len(masks)} CAM_BACK masks zero "
          f"from the warped row 700 on (rows "
          f"{[round(m['row'], 1) for m in masks]}); step walls "
          f"{[round(v, 1) for v in out['walls_ms']]} ms, loader waits "
          f"{[round(v, 1) for v in out['waits_ms']]} ms; evaluation of "
          f"{NUSC_VAL} frames in {len(ev_watch.forwards)} forwards, "
          f"{one['conv3x3']} conv3x3 launches each and nothing else, "
          f"{ev['seconds']:.2f} s = {out['eval_frames_per_s']:.2f} "
          f"frames/s; abs_rel {ev['errors'][0]:.4f} (scaled, all mean) "
          f"{ev['abs_errors'][0]:.4f} (absolute), per camera "
          f"{ {k: round(float(v[0][0]), 4) for k, v in ev['channels'].items()} }"
          f"; test.main on the card equal to the loop's within {same:.1e}, "
          f"against the CPU port's {vs_cpu:.2e} rel (a1-a3 "
          f"{a_vs_cpu:.2e}); run {run_s:.1f} s, test.main {card_s:.1f} s "
          f"card, {cpu_s:.1f} s CPU")
    return out


def distill_recipe_phase(counters, record, tree):
    """Phase 46: ``train.main`` on the port's ``distill_nusc_example.py``
    pointed at the same tree, its teacher a checkpoint of seeded weights
    written by the port's checkpoint save; every step launches what phase
    37's ``distill_nusc`` step launches, the teacher is bitwise unchanged
    after the steps, and the evaluation's metrics are finite."""
    from fsnet_tpu_torch.entry import flagship_model
    from fsnet_tpu_torch.runtime import checkpoint

    teacher_path = NUSC_DIR / "teacher.pth"
    checkpoint.save_models(str(teacher_path),
                           flagship_model(288, 512, device="cpu", seed=11))
    loaded = {}
    load_teacher = checkpoint.load_teacher

    def watched(model, path):
        out = load_teacher(model, path)
        loaded.update({n: t.detach().cpu().clone()
                       for n, t in model.state_dict().items()
                       if n.startswith("teacher_net.")})
        return out

    checkpoint.load_teacher = watched
    try:
        run, loop, ev_watch, over, run_s = nusc_loop(
            counters, DISTILL_CONFIG, tree,
            record["bf16_recipe_steps"]["distill"], "phase 46",
            teacher=teacher_path)
    finally:
        checkpoint.load_teacher = load_teacher
    state = run["model"].state_dict()
    moved = [n for n, t in loaded.items() if not torch.equal(state[n].cpu(),
                                                             t)]
    check(loaded and not moved, f"phase 46: {len(moved)} of the teacher's "
          f"{len(loaded)} tensors changed: {moved[:5]}")
    first = ev_watch.forwards[0]
    check(first["conv3x3"] > 0 and all(
        f == first for f in ev_watch.forwards) and all(
        n == 0 for k, n in first.items() if k != "conv3x3"),
        f"phase 46: evaluation forwards' launches {ev_watch.forwards}")
    ev = run["evals"][0]
    log = run["log"]
    out = dict(card=record["card"], run_s=run_s,
               losses=[e["loss"] for e in log],
               launches=record["bf16_recipe_steps"]["distill"]["launches"],
               teacher_tensors=len(loaded),
               eval_launches_per_forward=first,
               errors=ev["errors"].tolist(),
               abs_errors=ev["abs_errors"].tolist(),
               channels={k: [s.tolist() for s in v]
                         for k, v in ev["channels"].items()},
               eval_s=ev["seconds"], walls_ms=[e["wall_ms"] for e in log],
               waits_ms=[e["wait_ms"] for e in log])
    print(f"phase 46 ({record['card']}): train.main on "
          f"{DISTILL_CONFIG.name} from the written JPEG tree: "
          f"{NUSC_STEPS} steps, losses "
          f"{[round(x, 6) for x in out['losses']]}, launches per step phase "
          f"37's distill_nusc bf16 step; the teacher's {len(loaded)} "
          f"tensors (from {teacher_path.name}) bitwise unchanged; step "
          f"walls {[round(v, 1) for v in out['walls_ms']]} ms; evaluation "
          f"forwards {first} each, {ev['seconds']:.2f} s, abs_rel "
          f"{ev['errors'][0]:.4f} (scaled, all mean); run {run_s:.1f} s")
    return out


# phase 47: the KITTI-360 fisheye recipe from a PNG tree written on disk
FISH_CONFIG = (ROOT / "fsnet_tpu_torch" / "configs"
               / "kitti360_fisheye_example.py")
FISH_MASK = ROOT / "meta_data" / "kitti360_trainsub" / "fisheye_mask.png"
FISH_DIR = ROOT / "build" / "fisheye_tree"
# 16 frames a camera at 1400x1400; 48 training samples (3 steps of 16) on
# the 14 frames that have both neighbours, 8 val frames with scans;
# dataset[i] timed over FISH_SAMPLES samples a run, two runs
FISH_FRAMES, FISH_STEPS, FISH_SAMPLES = 16, 3, 2
FISH_VAL_FRAMES = (1, 3, 5, 7, 9, 11, 13, 14)


def write_fisheye_tree(dt, batch):
    """A KITTI-360 fisheye tree at 1400x1400 under ``build/fisheye_tree``
    (``disk_trees.write_kitti360_fisheye``: two Mei cameras, 16 frames of
    each, scans of the val frames), a train meta file of ``FISH_STEPS *
    batch`` samples and a val list. Returns the paths and the seconds it
    took."""
    import shutil

    shutil.rmtree(FISH_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    out = dt.write_kitti360_fisheye(str(FISH_DIR), dt.FISHEYE_H,
                                    dt.FISHEYE_W, FISH_FRAMES,
                                    velodyne=FISH_VAL_FRAMES)
    centres = range(1, FISH_FRAMES - 1)
    out["train"] = dt.write_split(FISH_DIR / "train.txt", [
        dt.fisheye_meta(centres[i % len(centres)])
        for i in range(FISH_STEPS * batch)])
    out["val"] = dt.write_split(FISH_DIR / "val.txt", [
        dt.fisheye_meta(k) for k in FISH_VAL_FRAMES])
    out["gt"] = str(FISH_DIR / "fisheye_gt_depth.npz")
    out["seconds"] = time.perf_counter() - t0
    return out


def fish_overrides(tree, ckpt_dir, **extra):
    """``kitti360_fisheye_example.py`` pointed at the written tree, one
    epoch evaluated after it, the encoder from seeded random weights and
    the evaluation loader in-process."""
    ev = "trainer.evaluate_hook."
    return {"train_dataset.cfg_list": [dict(
                name="fsnet_tpu_torch.data.datasets.fisheye_dataset."
                     "KITTI360FisheyeDataset", raw_path=tree["root"],
                split_file=tree["train"], fisheye_mask=str(FISH_MASK))],
            "val_dataset.raw_path": tree["root"],
            "val_dataset.split_file": tree["val"],
            ev + "dataset_eval_cfg.data_path": tree["root"],
            ev + "dataset_eval_cfg.split_file": tree["val"],
            ev + "dataset_eval_cfg.gt_saved_file": tree["gt"],
            ev + "num_workers": 0,
            "meta_arch.depth_backbone_cfg.pretrained": False,
            "trainer.max_epochs": 1, "trainer.test_iter": 1,
            "trainer.disp_iter": 1, "path.checkpoint_path": str(ckpt_dir),
            **extra}


def fish_sample_ms(tree, samples=FISH_SAMPLES):
    """``dataset[i]`` of the fisheye recipe's train dataset on the written
    tree (three 1400x1400 PNG reads, the mask's resize, the train graph to
    384x384 and the ray map) in one process: (ms of the first call, whose
    ray map is computed cold, and ms a sample over the next ``samples``)."""
    from fsnet_tpu_torch.utils import build, cfg_from_file, update_cfg

    cfg = update_cfg(cfg_from_file(str(FISH_CONFIG)),
                     **fish_overrides(tree, FISH_DIR / "unused"))
    dataset = build(**cfg.train_dataset)
    t0 = time.perf_counter()
    dataset[len(dataset) - 1]
    first = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for i in range(samples):
        dataset[i]
    return first, (time.perf_counter() - t0) / samples * 1e3


class MeiWatch:
    """Keeps kernel G's operands and outputs and kernel H's of the first
    train step, by wrapping ``warp_mei._launch_fwd`` and
    ``WarpMeiFunction.backward``; the wrappers' counters are not touched
    and no launch is added."""

    def __init__(self):
        from fsnet_tpu_torch.ops import warp_mei as twm

        self.twm, self.fwd, self.bwd = twm, None, None
        self.saved = launch, backward = (twm._launch_fwd,
                                         twm.WarpMeiFunction.backward)
        watch = self

        def launched(route, image, mask, norm, rays, rows, S, F, band,
                     with_mask):
            out = launch(route, image, mask, norm, rays, rows, S, F, band,
                         with_mask)
            if watch.fwd is None:
                watch.fwd = dict(
                    args=[t.clone() for t in (image, mask, norm, rays,
                                              rows)],
                    meta=(S, F, band, with_mask, route),
                    out=[None if t is None else t.clone() for t in out])
            return out

        def watched(ctx, g, o):
            grads = backward(ctx, g, o)
            if watch.bwd is None:
                norm, rays, rows, va, vb = ctx.saved_tensors
                watch.bwd = dict(args=[t.clone() for t in (
                    norm, rays, g.contiguous(), va, vb, rows)],
                    meta=(ctx.S, ctx.F), dnorm=grads[2].clone())
            return grads

        twm._launch_fwd = launched
        twm.WarpMeiFunction.backward = staticmethod(watched)

    def close(self):
        self.twm._launch_fwd = self.saved[0]
        self.twm.WarpMeiFunction.backward = staticmethod(self.saved[1])


def check_step_mei(watch):
    """Phase 47: kernel G's and H's launches of one loop step against
    their plain versions on the same operands, at phase 36's gates (G's
    out, va, vb and overlap bitwise; H within 1e-6 of the largest entry,
    one bf16 ulp beyond it where d norm is bfloat16). Returns the
    readings."""
    twm = watch.twm
    image, mask, norm, rays, rows = watch.fwd["args"]
    S, F, band, with_mask, route = watch.fwd["meta"]
    ref = twm.warp_mei_plain(image, mask, norm, rays, rows, S, F, band,
                             with_mask)
    out = watch.fwd["out"]
    fwd = max(float((a.float() - r.float()).abs().max())
              for a, r in zip((out[0], out[2], out[3]),
                              (ref[0], ref[2], ref[3])))
    ov = int((out[1] != ref[1]).sum())
    nrm, rays_b, g, va, vb, rows_b = watch.bwd["args"]
    dn_ref = twm.warp_mei_bwd_plain(nrm, rays_b, g, va, vb, rows_b,
                                    *watch.bwd["meta"])
    dn = watch.bwd["dnorm"]
    diff = (dn.float() - dn_ref.float()).abs()
    if dn.dtype == BF16:
        big = torch.maximum(dn.float().abs(), dn_ref.float().abs())
        diff = (diff - bf16_ulp(big)).clamp(min=0.0)
    bwd = diff.max().item() / dn_ref.float().abs().max().item()
    B = rays.shape[0]
    cams = rows[:B, 12:19].double().cpu().numpy()
    out = dict(route=route, image_dtype=str(image.dtype).split(".")[-1],
               norm_dtype=str(norm.dtype).split(".")[-1],
               fwd_max_abs_err=fwd, overlap_mismatches=ov,
               bwd_rel_err=bwd, warps=int(rows.shape[0]),
               cameras=len({tuple(c[:3]) for c in cams}),
               camera_rows=len({tuple(c) for c in cams}))
    check(fwd == 0 and ov == 0, f"phase 47: kernel G on the step's "
          f"operands: max abs err {fwd:.2e}, {ov} overlap mismatches")
    check(bwd <= 1e-6, f"phase 47: kernel H on the step's operands: "
          f"{bwd:.2e} of the largest entry > 1e-6")
    check(out["cameras"] == 2, f"phase 47: the step's rows hold "
          f"{out['cameras']} cameras")
    return out


def fisheye_recipe_phase(counters, record):
    """Phase 47: ``train.main`` on the port's
    ``kitti360_fisheye_example.py`` pointed at a written 1400x1400 tree
    (bf16, bs16 @384x384, 4 loader workers, one epoch of 3 steps, then the
    evaluation of 8 frames through ``KittiEvaluationHook`` and
    ``Kitti360FisheyeEvaluator``); every step's launches, dtypes and routes
    phase 37's fisheye step's, both cameras in every batch, G and H of the
    first step against their plain versions on its own operands; each
    evaluation forward 14 conv3x3 and nothing else; ``test.main`` on the
    saved checkpoint on the card and on the CPU; readings."""
    from fsnet_tpu_torch.evaluation.kitti360_fisheye_eval import \
        Kitti360FisheyeEvaluator
    from fsnet_tpu_torch.scripts import test as test_script
    from fsnet_tpu_torch.scripts import train as train_script
    from fsnet_tpu_torch.utils import cfg_from_file, update_cfg

    dt = disk_trees()
    cfg0 = cfg_from_file(str(FISH_CONFIG))
    tree = write_fisheye_tree(dt, cfg0.data.batch_size)
    synth, disk, first = [], [], []
    for _ in range(2):               # in turns: synthetic, fisheye tree
        synth.append(sample_ms(samples=FISH_SAMPLES))
        f, d = fish_sample_ms(tree)
        first.append(f)
        disk.append(d)
    t0 = time.perf_counter()
    gt = Kitti360FisheyeEvaluator(tree["root"], tree["val"], tree["gt"])
    gt_s = time.perf_counter() - t0
    close = [int(m.sum()) for m in gt.close_masks]
    check(len(gt.gt_depths) == len(FISH_VAL_FRAMES) and all(
        d.shape == (dt.FISHEYE_H, dt.FISHEYE_W) for d in gt.gt_depths)
        and min(close) > 100, f"phase 47: ground truth "
        f"{[(d.shape, int((d > 0).sum())) for d in gt.gt_depths]}, close "
        f"{close}")

    want = record["bf16_recipe_steps"]["fisheye"]
    over = fish_overrides(tree, FISH_DIR / "ckpt")
    loop = LoopWatch(counters, keep=("fisheye_params", "P2"))
    ev_watch, mei = EvalWatch(counters), MeiWatch()
    try:
        t0 = time.perf_counter()
        run = train_script.main(config=str(FISH_CONFIG), device="cuda",
                                **over)
        run_s = time.perf_counter() - t0
    finally:
        loop.close()
        ev_watch.close()
        mei.close()
    check(len(loop.steps) == FISH_STEPS and run["global_step"]
          == FISH_STEPS, f"phase 47: {len(loop.steps)} steps")
    batch_cams = []
    for i, s in enumerate(loop.steps):
        check(s["launches"] == want["launches"], f"phase 47 step {i}: "
              f"launches {s['launches']}, phase 37's {want['launches']}")
        check(all(s["dtypes"][k] == v for k, v in want["dtypes"].items()),
              f"phase 47 step {i}: launches by dtype {s['dtypes']}")
        check(all(s["routes"][k] == v for k, v in want["routes"].items()),
              f"phase 47 step {i}: routes {s['routes']}, phase 37's "
              f"{want['routes']}")
        params = s["batch"]["fisheye_params"].double().numpy()
        u0 = s["batch"]["P2"][:, 0, 2].double().numpy()
        batch_cams.append(dict(cameras=len({tuple(p) for p in params}),
                               u0=len(set(u0.tolist()))))
        check(batch_cams[-1]["cameras"] == 2, f"phase 47 step {i}: the "
              f"batch holds {batch_cams[-1]['cameras']} cameras")
    mei_check = check_step_mei(mei)
    losses = [e["loss"] for e in run["log"]]
    check(len(losses) == FISH_STEPS and all(np.isfinite(losses)),
          f"phase 47: losses {losses}")
    one = dict(dict.fromkeys(ev_watch.forwards[0], 0), conv3x3=len(SHAPES))
    check(len(ev_watch.forwards) == len(FISH_VAL_FRAMES)
          and all(f == one for f in ev_watch.forwards),
          f"phase 47: {len(ev_watch.forwards)} evaluation forwards, "
          f"launches {ev_watch.forwards[:2]}")
    check(len(run["evals"]) == 1, f"phase 47: {len(run['evals'])} "
          "evaluations")
    ev = run["evals"][0]
    check(all(np.isfinite(ev[k]).all() and ev[k].shape == (7,)
              for k in ("errors", "abs_errors")), f"phase 47: {ev}")

    t0 = time.perf_counter()
    card = test_script.main(config=str(FISH_CONFIG),
                            checkpoint=run["checkpoint"], device="cuda",
                            **over)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = test_script.main(config=str(FISH_CONFIG),
                           checkpoint=run["checkpoint"], device="cpu", **over)
    cpu_s = time.perf_counter() - t0
    same = max(rel_max(card[k], ev[k]) for k in ("errors", "abs_errors"))
    check(card["samples"] == len(FISH_VAL_FRAMES) and same <= 1e-6,
          f"phase 47: test.main {card} against the loop's evaluation {ev}")
    vs_cpu = max(rel_max(card[k][:4], cpu[k][:4])
                 for k in ("errors", "abs_errors"))
    a_vs_cpu = max(float(np.abs(card[k][4:] - cpu[k][4:]).max())
                   for k in ("errors", "abs_errors"))
    check(vs_cpu <= 1e-3, f"phase 47: card vs CPU metrics rel {vs_cpu:.3e}"
          f" > 1e-3: card {card}, CPU {cpu}")
    log = run["log"]
    n_val = len(FISH_VAL_FRAMES)
    out = dict(card=record["card"], tree_write_s=tree["seconds"],
               gt_precompute_s=gt_s, close_pixels=close,
               fish_sample_ms=disk, fish_first_sample_ms=first,
               synthetic_sample_ms=synth, run_s=run_s, losses=losses,
               launches=want["launches"], batch_cameras=batch_cams,
               mei_step=mei_check, eval_launches_per_frame=one,
               errors=ev["errors"].tolist(),
               abs_errors=ev["abs_errors"].tolist(), eval_s=ev["seconds"],
               eval_frames_per_s=n_val / ev["seconds"],
               test_main_card_s=card_s, test_main_cpu_s=cpu_s,
               test_main_vs_loop_rel=same, card_vs_cpu_rel=vs_cpu,
               card_vs_cpu_a_abs=a_vs_cpu,
               walls_ms=[e["wall_ms"] for e in log],
               waits_ms=[e["wait_ms"] for e in log])
    cfg = update_cfg(cfg0, **over)
    print(f"phase 47 ({record['card']}): tree of {FISH_FRAMES} 1400x1400 "
          f"frames a camera written in {tree['seconds']:.1f} s; dataset[i] "
          f"{', '.join(f'{v:.1f}' for v in disk)} ms a sample (first, cold "
          f"ray map: {', '.join(f'{v:.1f}' for v in first)}) against the "
          f"synthetic render's {', '.join(f'{v:.1f}' for v in synth)} "
          f"(alternated, {FISH_SAMPLES} samples each); train.main on "
          f"{FISH_CONFIG.name} ({cfg.trainer.training_hook.compute_dtype} "
          f"bs{cfg.data.batch_size}@{cfg.data.rgb_shape[0]}x"
          f"{cfg.data.rgb_shape[1]}, {cfg.data.num_workers} workers): "
          f"{FISH_STEPS} steps, losses {[round(x, 6) for x in losses]}, "
          f"launches per step phase 37's fisheye step, cameras per batch "
          f"{batch_cams}; the first step's G ({mei_check['route']} route, "
          f"{mei_check['image_dtype']} image, {mei_check['norm_dtype']} "
          f"norm, {mei_check['camera_rows']} distinct camera rows) bitwise "
          f"equal to its plain version, H {mei_check['bwd_rel_err']:.2e} of "
          f"the largest entry; step walls "
          f"{[round(v, 1) for v in out['walls_ms']]} ms, loader waits "
          f"{[round(v, 1) for v in out['waits_ms']]} ms; evaluation of "
          f"{n_val} frames, {one['conv3x3']} conv3x3 launches each and "
          f"nothing else, {ev['seconds']:.2f} s = "
          f"{out['eval_frames_per_s']:.2f} frames/s; abs_rel "
          f"{ev['errors'][0]:.4f} (scaled) {ev['abs_errors'][0]:.4f} "
          f"(absolute); test.main on the card equal to the loop's within "
          f"{same:.1e}, against the CPU port's {vs_cpu:.2e} rel (a1-a3 "
          f"{a_vs_cpu:.2e}); ground truth in {gt_s:.2f} s ({close} close "
          f"pixels); run {run_s:.1f} s, test.main {card_s:.1f} s card, "
          f"{cpu_s:.1f} s CPU")
    return out


# phase 48: FusionPortable on the card machine
FUSION_DIR = ROOT / "build" / "fusion_tree"
FUSION_FRAMES, FUSION_VAL = 7, (1, 2, 3, 4)
FUSION_SEEDS = (0, 1, 2)


def write_fusion_tree(dt, root):
    """The FusionPortable tree of phase 48 under ``root``: 7 frames a
    camera at 768x1024 (frame 5 repeats frame 4's pose, so the static
    filter drops the samples centred on 4 and 5), 30,000-point Ouster
    scans (ASCII PCD for even frames, binary for odd ones), a train split
    of the 5 frames with both neighbours and a val split of 4. Returns the
    paths."""
    out = dt.write_fusionportable(str(root), dt.FUSION_H, dt.FUSION_W,
                                  FUSION_FRAMES, static=(5,))
    out["train"] = dt.write_split(Path(root) / "train.txt",
                                  map(str, range(1, FUSION_FRAMES - 1)))
    out["val"] = dt.write_split(Path(root) / "val.txt",
                                map(str, FUSION_VAL))
    out["gt"] = str(Path(root) / "fusion_gt.npz")
    return out


def fusion_digests(dataset, evaluator):
    """SHA-256 of ``dataset[i]`` under an identity augmentation, sample i
    drawn after its camera generator is set to ``RandomState(FUSION_SEEDS
    [i])`` (every key; the relative poses, whose rotations come from
    scipy, rounded to 1e-6 first), and of each ground-truth map of
    ``evaluator``. Works on the JAX package's dataset too (its generator
    is numpy's global state)."""
    samples = []
    for i, seed in enumerate(FUSION_SEEDS):
        if hasattr(dataset, "rng"):
            dataset.rng = np.random.RandomState(seed)
        np.random.seed(seed)
        sample = dataset[i]
        keys = {}
        for k in sorted(sample, key=str):
            v = np.asarray(sample[k])
            if k[0] == "relative_pose":
                v = np.round(v.astype(np.float64), 6)
            keys[str(k)] = (f"{v.dtype}{v.shape}:"
                            f"{sha256(np.ascontiguousarray(v).tobytes())}")
        samples.append(sha256(json.dumps(keys, sort_keys=True).encode()))
    return dict(samples=samples, gt=[
        sha256(np.ascontiguousarray(d, np.float32).tobytes())
        for d in evaluator.gt_depths])


# recorded on the CPU (numpy 2.0.2, scipy 1.17.0, PyYAML 6.0.3) from the JAX
# package's dataset and evaluator, which the port's equal there
# (tests/test_torch_fusionportable.py); the card machine has no JAX
FUSION_DIGESTS = dict(
    samples=[
        "55a8493ef83b7d8457f1cdc58651ce19a6ff6504f93f66782607517ee46fd135",
        "d43f5fec007801d2631f5b3126dfa7b50a42431df2b1d76f4abb689b6a5220ee",
        "f5b3ecc067536857c5dbd229fd61395e82c355aac362221d7a97c86b14a94933"],
    gt=["f5d307ee8993941f93d6c21afc085344ca58345f7c5faefe73d6d0d42df68bf3",
        "32bc96a01277a733651fb0d553ae994cee174f1832a9526f54274c2bbb9d9746",
        "55d300db247888b333da81dfa4028e85bc19e7ca4db5c9c930fd4394121766f7",
        "de59f31739c471a135581222ac3fd9716093241c2c8493d9bdc224804df73f8b"])


def fusion_phase(counters, record):
    """Phase 48: FusionPortable on the card machine: a written tree
    (OpenCV yaml calibration, TUM odometry, PNG frames, PCD scans in ASCII
    and binary); ``dataset[i]`` and ``FusionPortableEvaluator``'s ground
    truth against the digests recorded on the CPU; one
    ``KittiEvaluationHook`` pass of the flagship model over the 4 val
    frames, each forward 14 conv3x3 and nothing else."""
    import shutil

    from fsnet_tpu_torch.configs.common import wpose_augmentation
    from fsnet_tpu_torch.entry import flagship_model
    from fsnet_tpu_torch.evaluation.fusionportable_eval import \
        FusionPortableEvaluator
    from fsnet_tpu_torch.utils import build
    from fsnet_tpu_torch.utils.easydict import EasyDict as edict

    dt = disk_trees()
    shutil.rmtree(FUSION_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    tree = write_fusion_tree(dt, FUSION_DIR)
    write_s = time.perf_counter() - t0
    ds_name = ("fsnet_tpu_torch.data.datasets.fusionportable_dataset."
               "FusionportableMonoDataset")
    dataset = build(name=ds_name, base_path=tree["root"],
                    split_file=tree["train"], odom_file=tree["odom"],
                    frame_idxs=[0, 1, -1], augmentation=edict(
                        name="fsnet_tpu_torch.data.augmentations.EmptyAug"))
    t0 = time.perf_counter()
    gt = FusionPortableEvaluator(tree["root"], tree["val"], tree["gt"])
    gt_s = time.perf_counter() - t0
    digests = fusion_digests(dataset, gt)
    check(len(dataset) == FUSION_FRAMES - 4, f"phase 48: {len(dataset)} "
          "samples after the static filter")
    check(digests == FUSION_DIGESTS, f"phase 48: digests {digests} "
          f"differ from those recorded on the CPU {FUSION_DIGESTS}")
    filled = [int((d > 0).sum()) for d in gt.gt_depths]
    check(min(filled) > 1000, f"phase 48: ground truth filled {filled}")

    model = flagship_model(HEIGHT, WIDTH, device="cuda", seed=0)
    val = build(name=ds_name, base_path=tree["root"], split_file=tree["val"],
                odom_file=tree["odom"], frame_idxs=[0, 1, -1],
                is_filter_static=False, use_right_image=False,
                augmentation=wpose_augmentation(
                    edict(rgb_shape=(HEIGHT, WIDTH, 3)), [0, 1, -1],
                    train=False))
    hook = build(
        name="fsnet_tpu_torch.pipeline_hooks.evaluation_hooks."
             "KittiEvaluationHook",
        test_run_hook_cfg=dict(
            name="fsnet_tpu_torch.pipeline_hooks.train_val_hooks."
                 "BaseValidationHook"),
        dataset_eval_cfg=dict(
            name="fsnet_tpu_torch.evaluation.fusionportable_eval."
                 "FusionPortableEvaluator", data_path=tree["root"],
            split_file=tree["val"], gt_saved_file=tree["gt"]),
        num_workers=0, device="cuda")
    ev_watch = EvalWatch(counters)
    try:
        t0 = time.perf_counter()
        errors, abs_errors = hook(model, val)
        eval_s = time.perf_counter() - t0
    finally:
        ev_watch.close()
    one = dict(dict.fromkeys(ev_watch.forwards[0], 0), conv3x3=len(SHAPES))
    check(len(ev_watch.forwards) == len(FUSION_VAL)
          and all(f == one for f in ev_watch.forwards),
          f"phase 48: {len(ev_watch.forwards)} evaluation forwards, "
          f"launches {ev_watch.forwards[:2]}")
    check(all(np.isfinite(s).all() and s.shape == (7,)
              for s in (errors, abs_errors)), f"phase 48: {errors}, "
          f"{abs_errors}")
    out = dict(card=record["card"], tree_write_s=write_s, gt_s=gt_s,
               gt_filled=filled, digests=digests,
               eval_launches_per_frame=one, errors=errors.tolist(),
               abs_errors=abs_errors.tolist(), eval_s=eval_s,
               eval_frames_per_s=len(FUSION_VAL) / eval_s)
    print(f"phase 48 ({record['card']}): FusionPortable tree of "
          f"{FUSION_FRAMES} frames a camera at {dt.FUSION_H}x{dt.FUSION_W} "
          f"written in {write_s:.1f} s; {len(dataset)} samples after the "
          f"static filter, dataset[i] of {len(FUSION_SEEDS)} samples and the "
          f"ground truth of {len(FUSION_VAL)} frames ({filled} pixels, "
          f"{gt_s:.2f} s) equal to the digests recorded on the CPU; "
          f"KittiEvaluationHook with FusionPortableEvaluator over "
          f"{len(FUSION_VAL)} frames, {one['conv3x3']} conv3x3 launches a "
          f"forward and nothing else, abs_rel {errors[0]:.4f} (scaled) "
          f"{abs_errors[0]:.4f} (absolute), {eval_s:.2f} s")
    return out


# phase 49: the exported dummy_forward program
EXPORT_DIR = ROOT / "build" / "export"
EXPORT_REPEATS, DISPATCH_ITERS = 20, 50


def forward_test_walls(model, batch, turns=("op", "direct", "direct", "op"),
                       iters=DISPATCH_ITERS):
    """Phase 49: the bs1 ``forward_test`` wall (host clock, the device
    synchronised after each call), ms a call over ``iters`` calls after
    3 warm-up calls, with the conv forward through the registered operator
    (``op``) and through the wrapper's launch alone (``direct``), in
    turns."""
    from fsnet_tpu_torch.ops import conv3x3 as tc
    from fsnet_tpu_torch.runtime.state import make_eval_step

    step = make_eval_step("cuda")
    saved = tc._forward

    def direct(parts, w, bias, pad_mode):
        tc._route(parts[0], "conv3x3")
        out = tc._launch_conv(parts, w, bias, pad_mode)
        tc._counted(tc.conv3x3, parts[0].dtype)
        return out

    walls = {k: [] for k in set(turns)}
    try:
        for turn in turns:
            tc._forward = saved if turn == "op" else direct
            for _ in range(3):
                step(model, batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                step(model, batch)
                torch.cuda.synchronize()
            walls[turn].append((time.perf_counter() - t0) / iters * 1e3)
    finally:
        tc._forward = saved
    return walls


def export_phase(counters, record):
    """Phase 49: the flagship's ``dummy_forward`` at bs1 @192x640 float32
    exported on the card (``runtime.export``), its graph calling the
    registered conv operator 14 times, saved, reloaded and run in a fresh
    Python process (``runtime.export``'s command line, TF32 off as in this
    run): equal to the live model within 1e-4 and 14 conv3x3 launches a
    run; the export,
    the reloaded and the live forward timed; the bs1 ``forward_test`` wall
    with and without the operator's dispatch, in turns."""
    import shutil

    from fsnet_tpu_torch.entry import flagship_model
    from fsnet_tpu_torch.ops import conv3x3 as tc
    from fsnet_tpu_torch.runtime import export

    shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    EXPORT_DIR.mkdir(parents=True)
    model = flagship_model(HEIGHT, WIDTH, device="cuda", seed=0)
    shape = (1, HEIGHT, WIDTH, 3)
    path = EXPORT_DIR / "flagship_dummy_forward.pt2"
    t0 = time.perf_counter()
    program = export.export_dummy_forward(model, shape, str(path))
    export_s = time.perf_counter() - t0
    ops = export.conv_ops(program)
    check(ops == len(SHAPES), f"phase 49: the exported graph calls the "
          f"conv operator {ops} times")
    aten_convs = sum(1 for n in program.graph.nodes
                     if n.op == "call_function"
                     and str(n.target).startswith("aten.conv"))
    smoke = export.smoke_check(str(path), model, shape)
    image = torch.from_numpy(np.random.RandomState(1).rand(*shape).astype(
        np.float32)).cuda()
    with torch.no_grad():
        live = {k: v.cpu() for k, v in model.dummy_forward(image).items()}
    torch.save(image, EXPORT_DIR / "image.pt")
    # the command line of runtime.export in a fresh interpreter, TF32 off
    # as in this run (phase 3), so that both sides compute in float32
    cmd = [sys.executable, "-c",
           "import sys, torch\n"
           "torch.backends.cuda.matmul.allow_tf32 = False\n"
           "torch.backends.cudnn.allow_tf32 = False\n"
           "from fsnet_tpu_torch.runtime import export\n"
           "export.main(sys.argv[1:])",
           str(path), str(EXPORT_DIR / "image.pt"),
           str(EXPORT_DIR / "result.pt"), "--repeats", str(EXPORT_REPEATS)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          cwd=str(ROOT))
    proc_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"phase 49: the reload process failed: "
          f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    res = torch.load(EXPORT_DIR / "result.pt")
    diff = max(float((res["outputs"][k] - live[k]).abs().max())
               for k in live)
    check(sorted(res["outputs"]) == sorted(live) and diff <= 1e-4,
          f"phase 49: the reloaded program {diff:.2e} from the live model")
    check(res["launches"] == len(SHAPES), f"phase 49: the reloaded "
          f"program launched conv3x3 {res['launches']} times")
    zero(counters)
    with torch.no_grad():
        model.dummy_forward(image)
    torch.cuda.synchronize()
    live_counts = read(counters)
    check(live_counts["conv3x3"] == len(SHAPES), f"phase 49: live forward "
          f"{live_counts}")

    def live_forward():
        with torch.no_grad():
            model.dummy_forward(image)

    live_ms = cuda_ms(live_forward, iters=EXPORT_REPEATS, warmup=3)
    walls = forward_test_walls(model, flagship_batch(1))
    op_ms = float(np.mean(walls["op"]))
    direct_ms = float(np.mean(walls["direct"]))
    reloaded_ms = res["ms"][1:]
    out = dict(card=record["card"], export_s=export_s, conv_ops=ops,
               aten_convolutions=aten_convs,
               smoke_max_diff=smoke["max_diff"], reload_max_abs_diff=diff,
               reload_launches=res["launches"],
               reload_load_ms=res["load_ms"],
               reloaded_forward_ms=float(np.median(reloaded_ms)),
               reloaded_first_ms=res["ms"][0], live_forward_ms=live_ms,
               reload_process_s=proc_s, forward_test_bs1_walls=walls,
               dispatch_ms_per_forward=op_ms - direct_ms,
               dispatch_us_per_conv=(op_ms - direct_ms) / len(SHAPES) * 1e3,
               size_bytes=path.stat().st_size)
    print(f"phase 49 ({record['card']}): dummy_forward bs1@{HEIGHT}x{WIDTH} "
          f"f32 exported in {export_s:.2f} s ({ops} calls of "
          f"torch.ops.fsnet_tpu_torch.conv3x3 in the graph beside the "
          f"encoder's {aten_convs} aten convolutions, "
          f"{out['size_bytes'] / 2**20:.1f} MiB saved), in-process smoke "
          f"check {smoke['max_diff']:.2e}; reloaded in a fresh process "
          f"({proc_s:.1f} s in all, load {res['load_ms']:.1f} ms): "
          f"{diff:.2e} from the live model, {res['launches']} conv3x3 "
          f"launches a run, forward {out['reloaded_forward_ms']:.3f} ms "
          f"(median of {len(reloaded_ms)}, host wall; first "
          f"{res['ms'][0]:.1f}) against the live forward's "
          f"{live_ms:.3f} ms (CUDA events); forward_test bs1 wall with the "
          f"registered operator {[round(v, 3) for v in walls['op']]} ms, "
          f"with the launch alone {[round(v, 3) for v in walls['direct']]} "
          f"ms (in turns): dispatch {out['dispatch_ms_per_forward']:.3f} ms "
          f"a forward, {out['dispatch_us_per_conv']:.1f} us a conv")
    return out


# --------------------------------- motion masks and post-opt (phases 50-52)

# phase 50: OpenCV's example settings, the precompute's default threshold
# (pixels at the flow's size); phase 51 scales it to its 192x640 masks
MASK_THRESHOLD, FLOW_REPEATS = 5.0, 3
TRAIN_THRESHOLD = MASK_THRESHOLD * HEIGHT / KITTI_H
MASK_DIR = DISK_DIR / "motion_masks"
# phase 51: a KITTI raw drive of its own with an object that moves on its
# own; each mask marks at least MOVER_INSIDE of the object, MOVER_RATIO
# times as densely as the rest
MOVER_DIR = DISK_DIR / "mover"
MOVER_INSIDE, MOVER_RATIO = 0.9, 3.0
# phase 52: the VO maps at nuScenes' unpadded evaluation input, 900x1600
# scaled by 0.32; val splits of its own over phase 45's frames: 8 frames
# a camera, and the first 2 for the card against the CPU
VO_H, VO_W = 288, 512
POSTOPT_VAL, POSTOPT_PAIR = 16, 2


def flow_pairs(tree):
    """(tag, grey frame 0, grey frame 1, P2, relative pose) of a 192x640
    pair of the synthetic render at two times and of the written KITTI
    tree's first training sample at 375x1242, the grey frames uint8 on the
    host through ``bgr_to_gray``."""
    from fsnet_tpu_torch.data.datasets.mono_dataset import \
        KittiDepthMonoDataset
    from fsnet_tpu_torch.data.datasets.synthetic_dataset import \
        SyntheticMonoDataset
    from fsnet_tpu_torch.ops.optical_flow import bgr_to_gray

    render = SyntheticMonoDataset(length=1, height=HEIGHT, width=WIDTH,
                                  frame_idxs=[0, 1], seed=4)[0]
    kitti = KittiDepthMonoDataset(
        raw_path=tree["raw"], split_file=tree["train"], frame_idxs=[0, 1, -1],
        augmentation=dict(name="fsnet_tpu_torch.data.augmentations."
                               "EmptyAug"))[0]
    out = []
    for tag, data in ((f"{HEIGHT}x{WIDTH}", render),
                      (f"{KITTI_H}x{KITTI_W}", kitti)):
        grey = [bgr_to_gray(torch.from_numpy(np.ascontiguousarray(
            data[("image", f)]))) for f in (0, 1)]
        out.append((tag, grey[0], grey[1], data["P2"],
                    data[("relative_pose", 1)]))
    return out


def flow_phase(record, tree):
    """Phase 50: the port's grey conversion, Farneback flow and PNG writer
    on the card. ``bgr_to_gray`` bitwise to its CPU run on a random
    375x1242 frame; ``farneback`` (OpenCV's example settings) on the card
    against the same code on the CPU at 192x640 and 375x1242, within 1e-3
    px (the two sum in other orders); the motion masks of the two flows
    (threshold 5) differ only where the CPU's |distance| lies within 1e-2
    of the threshold; ``write_png`` of the card's mask read back bitwise.
    Readings: ms a frame pair on the card (the flow and the mask)."""
    from fsnet_tpu_torch.configs.common import FARNEBACK_EXAMPLE
    from fsnet_tpu_torch.data.datasets import image_io
    from fsnet_tpu_torch.ops.optical_flow import bgr_to_gray, farneback
    from fsnet_tpu_torch.pipeline_hooks.precompute_hooks import \
        _epipolar_distance

    frame = torch.from_numpy(np.random.RandomState(50).randint(
        0, 256, (KITTI_H, KITTI_W, 3)).astype(np.uint8))
    grey_same = torch.equal(bgr_to_gray(frame.cuda()).cpu(),
                            bgr_to_gray(frame))
    check(grey_same, "phase 50: bgr_to_gray on the card differs from the "
          "CPU's")
    out = dict(card=record["card"], grey_bitwise=grey_same, pairs={})
    MASK_DIR.mkdir(parents=True, exist_ok=True)
    for tag, a, b, P2, pose in flow_pairs(tree):
        card = farneback(a.cuda(), b.cuda(), **FARNEBACK_EXAMPLE)
        torch.cuda.synchronize()
        cpu = farneback(a, b, **FARNEBACK_EXAMPLE)
        diff = (card.cpu() - cpu).abs()
        check(card.shape == cpu.shape and bool(torch.isfinite(card).all())
              and float(diff.max()) <= 1e-3, f"phase 50 {tag}: card vs CPU "
              f"flow max {float(diff.max()):.3e} px > 1e-3")
        d_card = _epipolar_distance(card, P2, pose)
        d_cpu = _epipolar_distance(cpu, P2, pose)
        m_card = (d_card.abs() > MASK_THRESHOLD).cpu()
        m_cpu = d_cpu.abs() > MASK_THRESHOLD
        differ = m_card != m_cpu
        edge = float((d_cpu.abs()[differ] - MASK_THRESHOLD).abs().max()
                     ) if bool(differ.any()) else 0.0
        check(edge <= 1e-2, f"phase 50 {tag}: masks differ {edge:.3e} from "
              "the threshold")
        path = str(MASK_DIR / f"check_{tag}.png")
        image_io.write_png(path, m_card.numpy().astype(np.uint8))
        back = image_io.read_png(path)
        check(np.array_equal(back, m_card.numpy().astype(np.uint8)),
              f"phase 50 {tag}: the written mask reads back otherwise")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(FLOW_REPEATS):
            f = farneback(a.cuda(), b.cuda(), **FARNEBACK_EXAMPLE)
            (_epipolar_distance(f, P2, pose).abs() > MASK_THRESHOLD).cpu()
        ms = (time.perf_counter() - t0) / FLOW_REPEATS * 1e3
        out["pairs"][tag] = dict(
            flow_max_abs=float(diff.max()), flow_mean_abs=float(diff.mean()),
            mask_pixels_differ=int(differ.sum()), mask_edge=edge,
            mask_share=float(m_card.float().mean()), pair_ms=ms)
    print(f"phase 50 ({record['card']}): bgr_to_gray bitwise to the CPU; "
          "farneback (OpenCV's example settings) on the card against the "
          "CPU: " + "; ".join(
              f"{t} max {v['flow_max_abs']:.2e} px, mean "
              f"{v['flow_mean_abs']:.2e} px, masks differ at "
              f"{v['mask_pixels_differ']} pixels (within {v['mask_edge']:.1e}"
              f" of the threshold), share of ones {v['mask_share']:.4f}, "
              f"{v['pair_ms']:.2f} ms a frame pair (flow and mask)"
              for t, v in out["pairs"].items())
          + "; write_png read back bitwise")
    return out


def halved_photo_fwd(want):
    """Phase 43's step with the photometric forward I launched once (the
    warped stack only, no identity stack)."""
    out = {k: (dict(v) if isinstance(v, dict) else v)
           for k, v in want.items()}
    out["launches"] = dict(want["launches"])
    out["launches"]["photo_loss_fwd"] //= 2
    for key in ("dtypes", "routes"):
        out[key] = {k: dict(v) for k, v in want[key].items()}
        if "photo_loss_fwd" in out[key]:
            out[key]["photo_loss_fwd"] = {
                r: n // 2 for r, n in want[key]["photo_loss_fwd"].items()}
    return out


def write_mover_tree(dt, batch):
    """Phase 51's KITTI raw tree at 375x1242 under ``build/disk_tree/mover``:
    one date with KITTI's calibration and a drive of 36 training samples
    (frames 1-36 of 38, the left camera) whose frames carry
    ``disk_trees.moving_object``, and its split file. Returns the paths and
    the seconds it took."""
    import shutil

    shutil.rmtree(MOVER_DIR, ignore_errors=True)
    raw = MOVER_DIR / "raw"
    t0 = time.perf_counter()
    dt.write_kitti_date(str(raw / DISK_DATE), KITTI_H, KITTI_W)
    n_train = DISK_STEPS * batch
    dt.write_kitti_drive(str(raw), DISK_TRAIN, n_train + 2, KITTI_H, KITTI_W,
                         seed=1, cams=("image_02",), mover=True)
    train = dt.write_split(MOVER_DIR / "train_files.txt", [
        f"{DISK_TRAIN} {i} l" for i in range(1, n_train + 1)])
    return dict(raw=str(raw), train=train,
                seconds=time.perf_counter() - t0)


def mover_shares(dt, masks, n):
    """(share of ones inside the moving object, share in the rest) of each
    of the ``n`` written 192x640 masks, mask k of frame k + 1: the object's
    box at 375x1242 scaled to the mask, its edges rounded inwards."""
    from fsnet_tpu_torch.data.datasets import image_io

    sy, sx = HEIGHT / KITTI_H, WIDTH / KITTI_W
    out = []
    for k in range(n):
        m = image_io.read_png(str(masks / f"{k:08d}.png")) > 0
        y0, x0, h, w = dt.mover_box(KITTI_H, KITTI_W, k + 1)
        box = np.zeros_like(m)
        box[math.ceil(y0 * sy):math.floor((y0 + h) * sy),
            math.ceil(x0 * sx):math.floor((x0 + w) * sx)] = True
        out.append((float(m[box].mean()), float(m[~box].mean())))
    return out


def motion_mask_phase(counters, record, tree):
    """Phase 51: ``train.main`` on the port's ``kitti_wpose_example.py``
    (bf16, bs12 @192x640, 4 loader workers) with ``is_motion_mask=True``
    on a 375x1242 drive of its own whose frames carry an object that
    moves on its own (phase 42's tree serves the validation split):
    ``MotionMaskPrecomputeHook`` (OpenCV's example settings, a resize-only
    augmentation to 192x640, phase 50's threshold of 5 px at 375x1242
    scaled to 192x640) writes the 36 masks before the datasets are built,
    then one epoch of 3 steps (no evaluation). Every mask marks at least
    90% of the object, at least 3 times as densely as the rest; every step
    launches phase 43's kernels but I once (no identity stack) and every
    batch carries a mask; the f32 bs2 step with a mask on the card against
    the CPU port at phase 10's gate."""
    import shutil

    from fsnet_tpu_torch.configs.common import motion_mask_hook
    from fsnet_tpu_torch.entry import flagship_model
    from fsnet_tpu_torch.scripts import train as train_script

    want = halved_photo_fwd(record["bf16_steps"]["grid"])
    check(want["launches"]["photo_loss_fwd"] == 1,
          f"phase 51: expected I once, from {want['launches']}")
    dt = disk_trees()
    mover = write_mover_tree(dt, BATCH)
    masks = MOVER_DIR / "masks"
    shutil.rmtree(masks, ignore_errors=True)
    child = dict(name="fsnet_tpu_torch.data.datasets.mono_dataset."
                      "KittiDepthMonoDataset",
                 raw_path=mover["raw"], split_file=mover["train"])
    over = disk_overrides(tree, DISK_DIR / "ckpt_mask", **{
        "train_dataset.cfg_list": [child],
        "train_dataset.is_motion_mask": True,
        "train_dataset.motion_mask_path": str(masks),
        "trainer.precompute_hook": motion_mask_hook(
            dict(child, frame_idxs=[0, 1, -1]), (HEIGHT, WIDTH), str(masks),
            distance_threshold=TRAIN_THRESHOLD),
        "trainer.test_iter": 2})
    loop = LoopWatch(counters, keep=("motion_mask",))
    try:
        t0 = time.perf_counter()
        run = train_script.main(config=str(KITTI_CONFIG), device="cuda",
                                **over)
        run_s = time.perf_counter() - t0
    finally:
        loop.close()
    pre = run["precompute"]
    n_train = DISK_STEPS * BATCH
    check(pre.written == n_train
          and len(list(masks.iterdir())) == n_train,
          f"phase 51: {pre.written} masks written of {n_train}")
    marked = mover_shares(dt, masks, n_train)
    check(all(i >= MOVER_INSIDE and i >= MOVER_RATIO * r for i, r in marked),
          f"phase 51: shares of ones (moving object, rest) {marked}")
    check(len(loop.steps) == DISK_STEPS and not run["evals"],
          f"phase 51: {len(loop.steps)} steps, {len(run['evals'])} "
          "evaluations")
    shares = []
    for i, s in enumerate(loop.steps):
        check(s["launches"] == want["launches"], f"phase 51 step {i}: "
              f"launches {s['launches']}, want {want['launches']}")
        check(all(s["dtypes"][k] == v for k, v in want["dtypes"].items()),
              f"phase 51 step {i}: launches by dtype {s['dtypes']}")
        check(s["routes"] == want["routes"], f"phase 51 step {i}: routes "
              f"{s['routes']}, want {want['routes']}")
        m = s["batch"].get("motion_mask")
        check(m is not None and tuple(m.shape) == (BATCH, HEIGHT, WIDTH)
              and m.dtype == torch.uint8 and int(m.max()) <= 1,
              f"phase 51 step {i}: motion mask "
              f"{None if m is None else (tuple(m.shape), m.dtype)}")
        shares.append(float(m.float().mean()))
    losses = [e["loss"] for e in run["log"]]
    check(len(losses) == DISK_STEPS and all(np.isfinite(losses)),
          f"phase 51: losses {losses}")
    small = white_noise_images({k: v[:2]
                                for k, v in flagship_masked_np().items()})
    small["motion_mask"] = loop.steps[0]["batch"]["motion_mask"][:2].numpy()
    vs_cpu = card_vs_cpu(flagship_model, small,
                         "phase 51 motion-mask step (grid route)")
    log = run["log"]
    out = dict(card=record["card"], run_s=run_s, launches=want["launches"],
               losses=losses, mask_share=shares,
               precompute_s=pre.seconds, precompute_masks=pre.written,
               tree_s=mover["seconds"],
               mover_inside_min=min(i for i, _ in marked),
               mover_rest_max=max(r for _, r in marked), card_vs_cpu=vs_cpu,
               walls_ms=[e["wall_ms"] for e in log],
               waits_ms=[e["wait_ms"] for e in log])
    print(f"phase 51 ({record['card']}): drive of {n_train + 2} frames at "
          f"{KITTI_H}x{KITTI_W} with a moving object written in "
          f"{mover['seconds']:.1f} s; MotionMaskPrecomputeHook wrote "
          f"{pre.written} masks at {HEIGHT}x{WIDTH} in {pre.seconds:.2f} s "
          f"(threshold {TRAIN_THRESHOLD:.3f} px; "
          f"{pre.seconds / pre.written * 1e3:.1f} ms a sample: dataset[i] "
          f"at {KITTI_H}x{KITTI_W}, the resize, the flow and the PNG); each "
          f"marks at least "
          f"{out['mover_inside_min']:.4f} of the moving object, at most "
          f"{out['mover_rest_max']:.4f} of the rest; "
          f"train.main with is_motion_mask: {DISK_STEPS} steps, losses "
          f"{[round(x, 6) for x in losses]}, launches per step phase 43's "
          f"with I once: {want['launches']}; share of ones in the batches' "
          f"masks {[round(x, 4) for x in shares]}; step walls "
          f"{[round(v, 1) for v in out['walls_ms']]} ms, loader waits "
          f"{[round(v, 1) for v in out['waits_ms']]} ms; run {run_s:.1f} s")
    return out


def postopt_phase(counters, record, tree):
    """Phase 52: ``test.main`` on phase 45's checkpoint with
    ``trainer.evaluate_hook`` set to ``PostOptFastNuscEvaluationHook`` over
    val splits of its own on phase 45's frames (``disk_trees.
    write_nusc_val``), each frame with a VO PNG at 288x512
    (``disk_trees.write_nusc_vo``: the frame's own ground truth with 5%
    log-normal noise): 16 frames (8 a camera, CAM_FRONT and CAM_BACK in
    turn) on the card, each forward 14 conv3x3 and nothing else of the
    hand-written kernels, every metric finite, no frame left unrefined, the
    same frames' unrefined metrics beside them (the config's
    ``FastNuscEvaluationHook``); the first 2 frames on the card and on the
    CPU, the card's continuous metrics within 1e-3 relative of the CPU
    port's (a1-a3 reported); the SLIC assignment of the first frame's
    refine on the card equal to the CPU's on at least 99.9% of the pixels.
    Readings: post-opt ms a frame, the evaluation pass's frames/s."""
    from fsnet_tpu_torch.evaluation.nuscenes_unsupervised_eval import \
        generate_depth_map
    from fsnet_tpu_torch.ops import postopt as tpo
    from fsnet_tpu_torch.pipeline_hooks import evaluation_hooks as teh
    from fsnet_tpu_torch.scripts import test as test_script

    dt = disk_trees()
    t0 = time.perf_counter()
    overs, points = {}, []
    for n in (POSTOPT_VAL, POSTOPT_PAIR):
        val = dt.write_nusc_val(tree, f"postopt_{n}", n, generate_depth_map)
        vo = dt.write_nusc_vo(val, "samples_vo", VO_H, VO_W, seed=52,
                              depth_map=generate_depth_map)
        check(len(vo["paths"]) == n and min(vo["points"]) > 1000,
              f"phase 52: VO maps {vo['points']}")
        points += vo["points"]
        overs[n] = nusc_overrides(dict(tree, **val), NUSC_DIR / "unused",
                                  **{"val_dataset.vo_path": vo["vo_path"]})
    vo_s = time.perf_counter() - t0
    hook = {"trainer.evaluate_hook.name": "fsnet_tpu_torch.pipeline_hooks."
                                          "evaluation_hooks."
                                          "PostOptFastNuscEvaluationHook"}
    ckpt = record["nusc_recipe"]["checkpoint"]

    def run(n, device, post_opt=True):
        res = test_script.main(config=str(NUSC_CONFIG), checkpoint=ckpt,
                               device=device,
                               **dict(overs[n], **(hook if post_opt else {})))
        if post_opt:
            check(res["samples"] == n and res["post_opt"]["refined"] == n
                  and res["post_opt"]["unrefined"] == 0,
                  f"phase 52 ({n} frames, {device}): post_opt "
                  f"{res['post_opt']}")
        return res

    captured = []
    refine = teh.post_optimization

    def kept(*args, **kw):
        if not captured:
            captured.append((args, kw))
        return refine(*args, **kw)

    ev_watch = EvalWatch(counters)
    teh.post_optimization = kept
    try:
        card = run(POSTOPT_VAL, "cuda")
    finally:
        teh.post_optimization = refine
        ev_watch.close()
    one = dict(dict.fromkeys(ev_watch.forwards[0], 0), conv3x3=len(SHAPES))
    check(ev_watch.forwards and all(f == one for f in ev_watch.forwards),
          f"phase 52: evaluation forwards' launches {ev_watch.forwards}")
    plain = run(POSTOPT_VAL, "cuda", post_opt=False)
    pair_card, pair_cpu = run(POSTOPT_PAIR, "cuda"), run(POSTOPT_PAIR, "cpu")

    def suites(res):
        out = {"all": (res["errors"], res["abs_errors"])}
        out.update(res["channels"])
        return out

    card_r, plain_r = suites(card), suites(plain)
    pair_r, cpu_r = suites(pair_card), suites(pair_cpu)
    check(sorted(card_r) == sorted(plain_r) == sorted(pair_r)
          == sorted(cpu_r) and all(
              np.isfinite(s).all() and s.shape == (7,)
              for r in (card_r, plain_r, pair_r, cpu_r)
              for v in r.values() for s in v),
          f"phase 52: metrics card {card_r}, unrefined {plain_r}, "
          f"{POSTOPT_PAIR} frames card {pair_r} CPU {cpu_r}")
    vs_cpu = max(rel_max(a[:4], b[:4]) for k in pair_r
                 for a, b in zip(pair_r[k], cpu_r[k]))
    a_vs_cpu = max(float(np.abs(a[4:] - b[4:]).max()) for k in pair_r
                   for a, b in zip(pair_r[k], cpu_r[k]))
    check(vs_cpu <= 1e-3, f"phase 52: card vs CPU metrics rel {vs_cpu:.3e}"
          f" > 1e-3: card {pair_r}, CPU {cpu_r}")
    (image, uvz, *_), kw = captured[0]
    slic_kw = {k: kw[k] for k in ("lab_dist_weight", "iter_num",
                                  "depth_dist_weight", "image_dist_weight")}
    a_card, a_cpu = (tpo.slic_assign(tpo.rgb2lab(im), u, kw["h_seg"],
                                     kw["w_seg"], **slic_kw)[0].cpu()
                     for im, u in ((image, uvz), (image.cpu(), uvz.cpu())))
    agree = float((a_card == a_cpu).float().mean())
    check(agree >= 0.999, f"phase 52: SLIC assignments agree on "
          f"{agree:.5f} of the pixels")
    frames_s = POSTOPT_VAL / card["seconds"]
    per_frame = card["post_opt"]["seconds"] / POSTOPT_VAL * 1e3
    out = dict(card=record["card"], vo_points=points, vo_write_s=vo_s,
               eval_launches_per_forward=one,
               eval_forwards=len(ev_watch.forwards),
               refined={k: [s.tolist() for s in v]
                        for k, v in card_r.items()},
               unrefined={k: [s.tolist() for s in v]
                          for k, v in plain_r.items()},
               card_vs_cpu_rel=vs_cpu, card_vs_cpu_a_abs=a_vs_cpu,
               slic_agreement=agree, postopt_ms_per_frame=per_frame,
               postopt_ms_per_frame_cpu=pair_cpu["post_opt"]["seconds"]
               / POSTOPT_PAIR * 1e3,
               eval_s=card["seconds"], eval_frames_per_s=frames_s,
               eval_s_unrefined=plain["seconds"],
               eval_s_cpu=pair_cpu["seconds"])
    print(f"phase 52 ({record['card']}): val splits and VO maps at "
          f"{VO_H}x{VO_W} ({min(points)}-{max(points)} points) written in "
          f"{vo_s:.1f} s; PostOptFastNuscEvaluationHook over {POSTOPT_VAL} "
          f"frames ({POSTOPT_VAL // 2} a camera) on phase 45's checkpoint: "
          f"{len(ev_watch.forwards)} forwards, {one['conv3x3']} conv3x3 "
          f"launches each and nothing else; {card['post_opt']['refined']} "
          f"frames refined, {card['post_opt']['unrefined']} left; abs_rel "
          f"refined against unrefined on the same frames (all mean): scaled "
          f"{card['errors'][0]:.4f} vs {plain['errors'][0]:.4f}, absolute "
          f"{card['abs_errors'][0]:.4f} vs {plain['abs_errors'][0]:.4f}; "
          f"card vs CPU port over {POSTOPT_PAIR} frames {vs_cpu:.2e} rel "
          f"(a1-a3 {a_vs_cpu:.2e}); SLIC assignments agree on {agree:.5f} "
          f"of the pixels; post-opt {per_frame:.1f} ms a frame on the card "
          f"({out['postopt_ms_per_frame_cpu']:.0f} on the CPU); evaluation "
          f"pass (reading, forward, refine, metrics) {card['seconds']:.2f} "
          f"s = {frames_s:.2f} frames/s ({plain['seconds']:.2f} s "
          f"unrefined)")
    return out


def main() -> int:
    global REPEATS
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--conv-repeats", type=int, default=REPEATS,
                    help="launches of each conv kernel per shape in phases "
                         "8 and 17 (default %(default)s)")
    REPEATS = max(1, ap.parse_args().conv_repeats)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from fsnet_tpu_torch.entry import flagship_model
    from fsnet_tpu_torch.models.blocks import Conv3x3
    from fsnet_tpu_torch.ops import _build
    from fsnet_tpu_torch.ops.conv3x3 import (conv3x3, conv3x3_dx,
                                             conv3x3_dx_plain, conv3x3_plain)
    from fsnet_tpu_torch.runtime.state import make_eval_step

    counters = launch_counters()

    record = {"elapsed_s": {}}
    t_run = time.perf_counter()

    def stamp(phases):
        """The run's seconds after ``phases``, kept and printed."""
        record["elapsed_s"][phases] = time.perf_counter() - t_run
        print(f"elapsed after phases {phases}: "
              f"{record['elapsed_s'][phases]:.1f} s", flush=True)

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    record["card"] = smi

    # 2. build
    t0 = time.time()
    logs = _build.build_all()
    record["build_s"] = time.time() - t0
    print(f"kernels built in {record['build_s']:.1f} s")
    record["ptxas"] = {}
    for name, log in logs.items():
        if name == "photo_loss":
            continue
        record["ptxas"][name] = ptxas_lines(log)
        for kname, lines in record["ptxas"][name].items():
            for line in lines:
                print(f"  ptxas {name} {kname}: {line}")
    record["bf16_ptxas"] = bf16_ptxas(logs)
    record["conv_sass"] = conv_sass(_build)
    record["warp_sass"] = warp_sass(_build)
    record["photo_sass"] = photo_build(_build, logs.get("photo_loss", ""))

    # 3. full float32 references
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 4. kernel against its plain version at the main path's shapes: the
    # forward in both dtypes, and the bfloat16 input cotangent (the float32
    # one is phase 8's)
    shapes = []
    for i, (name, H, W, Cs, Co, pad) in enumerate(SHAPES):
        row = dict(name=name, B=BATCH, H=H, W=W, Cs=list(Cs), Co=Co, pad=pad)
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            parts, w, b = conv_inputs(BATCH, H, W, Cs, Co, dtype, seed=i)
            out = conv3x3(parts, w, b, pad)
            torch.cuda.synchronize()
            ref = conv3x3_plain(parts, w, b, pad)
            diff = (out.float() - ref.float()).abs().max().item()
            rel = diff / ref.float().abs().max().item()
            row[f"max_abs_err_{tag}"], row[f"rel_err_{tag}"] = diff, rel
            check(out.shape == ref.shape and bool(torch.isfinite(out).all()),
                  f"{name} {tag}: bad output")
            check(rel <= TOL[dtype], f"{name} {tag}: rel err {rel:.3e} > "
                  f"{TOL[dtype]:.0e}")
            if dtype == torch.bfloat16:
                gy = torch.randn(BATCH, H, W, Co, device="cuda",
                                 generator=torch.Generator(device="cuda")
                                 .manual_seed(100 + i)).to(dtype)
                dxs = conv3x3_dx(gy, w, pad, Cs)
                torch.cuda.synchronize()
                dx_errs = [rel_err(a, r) for a, r in
                           zip(dxs, conv3x3_dx_plain(gy, w, pad, Cs))]
                rel = max(e for _, e in dx_errs)
                row["dx_rel_err_bf16"] = rel
                row["dx_max_abs_err_bf16"] = max(d for d, _ in dx_errs)
                check(rel <= TOL[dtype], f"{name} bf16 dx: rel err "
                      f"{rel:.3e} > {TOL[dtype]:.0e}")
        print(f"check {name:11s} B{BATCH} {H}x{W} {'+'.join(map(str, Cs))}"
              f"->{Co} {pad:9s} rel err f32 {row['rel_err_f32']:.2e} "
              f"bf16 {row['rel_err_bf16']:.2e} bf16 dx "
              f"{row['dx_rel_err_bf16']:.2e}")
        shapes.append(row)

    # 5. the main path, through the entry points a user calls
    model = flagship_model(HEIGHT, WIDTH, device="cuda", seed=0)
    eval_step = make_eval_step("cuda")
    seen = []
    hooks = [m.register_forward_pre_hook(lambda m, args: seen.append(args[0]))
             for m in model.modules() if isinstance(m, Conv3x3)]
    batch = flagship_batch(BATCH)
    zero(counters)
    pred = eval_step(model, batch)
    torch.cuda.synchronize()
    eval_counts = read(counters)
    launches = eval_counts["conv3x3"]
    for h in hooks:
        h.remove()
    seen_shapes = []
    for x in seen:
        parts = x if isinstance(x, tuple) else (x,)
        seen_shapes.append((parts[0].shape[1], parts[0].shape[2],
                            tuple(p.shape[3] for p in parts)))
    want = [(H, W, Cs) for _, H, W, Cs, _, _ in SHAPES]
    check(sorted(seen_shapes) == sorted(want),
          f"main path conv shapes {seen_shapes} differ from {want}")
    check(launches == len(SHAPES), f"{launches} conv3x3 launches in one "
          f"forward, expected {len(SHAPES)}")
    check(all(n == 0 for k, n in eval_counts.items() if k != "conv3x3"),
          f"the eval path launched training kernels: {eval_counts}")
    depth = pred["depth"]
    check(tuple(depth.shape) == (BATCH, HEIGHT, WIDTH, 1),
          f"depth shape {tuple(depth.shape)}")
    check(bool(torch.isfinite(depth).all()), "depth has non-finite values")
    dmin, dmax = depth.min().item(), depth.max().item()
    check(0.5 <= dmin and dmax <= 100.0, f"depth range [{dmin}, {dmax}]")
    print(f"main path: forward_test bs{BATCH}@{HEIGHT}x{WIDTH} f32, "
          f"{launches} conv3x3 launches, depth in [{dmin:.4f}, {dmax:.4f}]")
    record["main_path"] = dict(launches=launches, depth_min=dmin,
                               depth_max=dmax)

    # 6. the card against the CPU port, same weights and input
    small = {k: v[:2] for k, v in batch.items()}
    on_card = eval_step(model, small)["depth"].cpu().numpy()
    cpu_model = flagship_model(HEIGHT, WIDTH, device="cpu", seed=0)
    on_cpu = make_eval_step("cpu")(cpu_model, small)["depth"].numpy()
    rel = float(np.abs(on_card - on_cpu).max() / np.abs(on_cpu).max())
    check(rel <= 1e-3, f"card vs CPU depth rel-max {rel:.3e} > 1e-3")
    print(f"card vs CPU port, bs2: depth rel-max {rel:.3e}")
    record["card_vs_cpu_rel"] = rel

    # 7. timings
    b1 = flagship_batch(1)
    lat = cuda_ms(lambda: eval_step(model, b1), iters=20, warmup=3)
    fwd12 = cuda_ms(lambda: eval_step(model, batch), iters=10, warmup=2)
    record["forward_test"] = dict(bs1_ms=lat, bs12_ms=fwd12,
                                  bs12_imgs_per_s=BATCH / fwd12 * 1e3)
    print(f"forward_test bs1 latency {lat:.3f} ms; bs12 {fwd12:.3f} ms = "
          f"{BATCH / fwd12 * 1e3:.1f} imgs/s")
    tot = dict(ms=0.0, plain_ms=0.0, ops_ms=0.0, bytes_ms=0.0,
               conv2d_ms=0.0, ops=0.0, nbytes=0.0, lib_ms=0.0,
               lib_kernel_ms=0.0, lib_shapes=[])
    # the yardstick gets cuDNN's fastest algorithm: its first (warm-up)
    # call autotunes
    torch.backends.cudnn.benchmark = True
    for i, (row, (name, H, W, Cs, Co, pad)) in enumerate(zip(shapes, SHAPES)):
        parts, w, b = conv_inputs(BATCH, H, W, Cs, Co, torch.float32, seed=i)
        row["ms"] = cuda_ms(lambda: conv3x3(parts, w, b, pad), iters=20)
        row["plain_ms"] = cuda_ms(lambda: conv3x3_plain(parts, w, b, pad),
                                  iters=5)
        xc = torch.cat(parts, dim=-1).permute(0, 3, 1, 2)   # channels-last
        wc = w.permute(3, 2, 0, 1).contiguous()
        row["conv2d_ms"] = cuda_ms(lambda: F.conv2d(xc, wc, b, padding=1),
                                   iters=20)
        # one PyTorch call computes this very function only for a one-part
        # zero-padded conv
        row["library_ms"] = (row["conv2d_ms"] if len(Cs) == 1
                             and pad == "zeros" else None)
        (row["bound_ms"], row["bound_by"], ops_ms,
         bytes_ms) = bound(BATCH, H, W, Cs, Co, torch.float32)
        row["bf16_bound_ms"] = bound(BATCH, H, W, Cs, Co, torch.bfloat16)[0]
        ops, nbytes = conv_work(BATCH, H, W, Cs, Co)
        row["tc_bound_ms"], row["tc_bound_by"] = tc_bound(ops, nbytes)
        for k in ("ms", "plain_ms", "conv2d_ms"):
            tot[k] += row[k]
        tot["ops_ms"] += ops_ms
        tot["bytes_ms"] += bytes_ms
        tot["ops"] += ops
        tot["nbytes"] += nbytes
        if row["library_ms"] is not None:
            tot["lib_ms"] += row["library_ms"]
            tot["lib_kernel_ms"] += row["ms"]
            tot["lib_shapes"].append(name)
        print(f"time  {name:11s} kernel {row['ms']:.4f} ms  plain "
              f"{row['plain_ms']:.4f} ms  F.conv2d {row['conv2d_ms']:.4f} ms"
              + ("" if row["library_ms"] is None else " (cuDNN, the same "
                 "function)")
              + f"  bound f32 {row['bound_ms']:.4f} ms ({row['bound_by']}), "
              f"3xTF32 {row['tc_bound_ms']:.4f} ms ({row['tc_bound_by']})")
    torch.backends.cudnn.benchmark = False
    record["shapes"] = shapes

    tc_ms, tc_by = tc_bound(tot["ops"], tot["nbytes"])
    kernel = dict(
        name="conv3x3", route="cuda", source="fsnet_tpu_torch/csrc/conv3x3.cu",
        replaces="fsnet_tpu/ops/pallas/conv_kernel.py:210",
        launches=launches,
        max_abs_err=max(r["max_abs_err_f32"] for r in shapes),
        max_abs_err_bf16=max(r["max_abs_err_bf16"] for r in shapes),
        ms=tot["ms"], plain_ms=tot["plain_ms"],
        bound_ms=max(tot["ops_ms"], tot["bytes_ms"]),
        bound_by="operations" if tot["ops_ms"] >= tot["bytes_ms"] else "bytes",
        tc_bound_ms=tc_ms, tc_bound_by=tc_by,
        library_ms=tot["lib_ms"], library_shapes=tot["lib_shapes"],
        ms_library_shapes=tot["lib_kernel_ms"], conv2d_ms=tot["conv2d_ms"],
        note="eval path (forward_test): ms, plain_ms, bound_ms (float32 "
             "CUDA cores), tc_bound_ms (3xTF32 tensor cores), conv2d_ms are "
             "sums over the 14 decoder convs of one bs12 forward, float32; "
             "library_ms: F.conv2d (cuDNN) at library_shapes, "
             "ms_library_shapes the kernel there")

    print(f"time  conv3x3 (eval, 14 convs) kernel {kernel['ms']:.4f} ms  "
          f"plain {kernel['plain_ms']:.4f} ms  bound f32 "
          f"{kernel['bound_ms']:.4f} ms ({kernel['bound_by']})  3xTF32 bound "
          f"{kernel['tc_bound_ms']:.4f} ms ({kernel['tc_bound_by']})  cuDNN "
          f"{kernel['library_ms']:.4f} ms vs kernel "
          f"{kernel['ms_library_shapes']:.4f} ms at "
          f"{len(kernel['library_shapes'])} shapes")

    stamp("1-7")
    # 8-11. the train path
    train = train_phases(counters, record)
    kernel["launches_train_path"] = train["counts"]["conv3x3"]

    stamp("8-11")
    # 12-16. the grid route: patched-mask batches and learned poses
    grid_kernels = grid_phases(counters, record, train)

    stamp("12-16")
    # 17-21. the KITTI-360 fisheye recipe: Mei camera, norm-direct warp
    mei_kernels, fish_counts, fish = fisheye_phases(counters, record, train)
    kernel["launches_fisheye_path"] = fish_counts["conv3x3"]
    for e in train["kernels"]:
        if e["name"].startswith("conv3x3"):
            e["launches_fisheye_path"] = fish_counts[e["name"]]

    stamp("17-21")
    # 22. the photometric loss kernels at both recipes
    photo_kernels = photo_phases(record, train, fish)

    stamp("22")
    # 23-26. the DLA-34 + DLASegUpsample path: deformable convs (E, K)
    kernel_k, e_dla = dla_phases(counters, record)
    for e in grid_kernels:
        if e["name"] == "warp_grid_fwd":
            e.update(e_dla)
            e["note"] += ("; dla_*: the 16 DCNs of one bs12 @192x640 DLA "
                          "step (phases 23-26), launches over its 3 steps")

    stamp("23-26")
    # 27-31. the nuScenes recipes: the nusc_wpose step and the distillation
    # step with its frozen teacher, bs8 @288x512
    kernels = ([kernel] + train["kernels"] + grid_kernels + mei_kernels
               + photo_kernels + [kernel_k])
    add_nusc_readings(kernels, nusc_phases(counters, record))

    stamp("27-31")
    # 32-35. the bf16 step: each bf16 form against its plain version, the
    # launches, routes and dtypes of one bf16 step of each route, the card
    # against the CPU port, and the steps' and kernels' times
    bf16_entries, warp_bf16 = bf16_phases(counters, record, train, shapes)
    for e in kernels:
        if e["name"] in warp_bf16:
            e["bf16"] = warp_bf16[e["name"]]
            e["note"] = e.get("note", "") + (
                "; bf16: the bf16 step's launches of this float32 kernel "
                "(the image widened at the wrapper, out, va, vb rounded), "
                "ms through the wrapper with those passes beside the "
                "kernel alone, the bound at bf16 bytes (phases 33, 35)")
    kernels += bf16_entries

    stamp("32-35")
    # 36-39. every shipped recipe's step at its shipped dtype: kernels G and
    # H in bf16 against their plain versions (and the conv kernels at the
    # one-channel uncertainty convs), one bf16 step of the fisheye and the
    # two nuScenes recipes with launches by dtype, each against the CPU
    # port, and the steps timed in float32 and bf16
    mei_bf16, record["bf16_co1_errs"] = recipe_bf16_phases(counters, record,
                                                           fish)
    kernels += mei_bf16

    stamp("36-39")
    # 40-41. the flagship recipe trained from its dataset through the
    # port's train.py and evaluated through its test.py; the loop's
    # readings
    record["train_loop"] = train_loop_phase(counters, record)
    record["train_loop_readings"] = loop_readings(record,
                                                  record["train_loop"])

    stamp("40-41")
    # 42-43. the KITTI raw recipe from a PNG tree written on disk: the
    # port's PNG reader, then train.main with the evaluation hook and
    # test.main on the card and on the CPU
    record["png_reader"] = reader_phase(record)
    record["disk_recipe"] = disk_recipe_phase(counters, record,
                                              record["png_reader"]["tree"])
    kernel["launches_kitti_eval_per_frame"] = \
        record["disk_recipe"]["eval_launches_per_frame"]["conv3x3"]

    stamp("42-43")
    # 44-46. the nuScenes recipes from a JPEG tree written on disk: the
    # port's JPEG decoder, then train.main on nusc_wpose with the
    # per-camera evaluation and test.main on the card and on the CPU, then
    # train.main on distill_nusc with a teacher from a checkpoint
    record["jpeg_reader"] = jpeg_phase(record)
    tree = record["jpeg_reader"]["tree"]
    record["nusc_recipe"] = nusc_recipe_phase(counters, record, tree)
    record["distill_recipe"] = distill_recipe_phase(counters, record, tree)
    kernel["launches_nusc_eval_per_forward"] = \
        record["nusc_recipe"]["eval_launches_per_forward"]["conv3x3"]

    stamp("44-46")
    # 47-49. the KITTI-360 fisheye recipe from a PNG tree (the last shipped
    # config without a run from disk), FusionPortable's dataset and
    # evaluator, and the exported dummy_forward program
    record["fisheye_recipe"] = fisheye_recipe_phase(counters, record)
    record["fusion"] = fusion_phase(counters, record)
    record["export"] = export_phase(counters, record)
    kernel["launches_fisheye_eval_per_frame"] = \
        record["fisheye_recipe"]["eval_launches_per_frame"]["conv3x3"]
    kernel["launches_fusion_eval_per_frame"] = \
        record["fusion"]["eval_launches_per_frame"]["conv3x3"]
    kernel["launches_exported_program"] = record["export"]["reload_launches"]
    loop_step = record["fisheye_recipe"]["launches"]
    for e in kernels:
        base = e["name"].removesuffix("_bf16")
        if loop_step.get(base):
            e["launches_fisheye_loop_per_step"] = loop_step[base]

    stamp("47-49")
    # 50-52. the motion-mask path and the VO post-optimisation: the port's
    # Farneback flow, grey conversion and PNG writer on the card; the KITTI
    # raw recipe precomputing its masks and training on them through
    # train.py; the nuScenes evaluation with post-optimisation through
    # test.py on the card and on the CPU
    record["flow"] = flow_phase(record, record["png_reader"]["tree"])
    record["motion_masks"] = motion_mask_phase(
        counters, record, record["png_reader"]["tree"])
    record["postopt"] = postopt_phase(counters, record, tree)
    kernel["launches_nusc_postopt_eval_per_forward"] = \
        record["postopt"]["eval_launches_per_forward"]["conv3x3"]
    mask_step = record["motion_masks"]["launches"]
    for e in kernels:
        base = e["name"].removesuffix("_bf16")
        if mask_step.get(base):
            e["launches_motion_mask_step"] = mask_step[base]

    stamp("50-52")
    # 53-56. the DLA and the pose nets at bf16: kernels E and K in bf16 at
    # the DCN shapes, the DLA's bf16 step, the learned-pose MonoDepthMeta's
    # bf16 step and the residual-pose MonoDepthWPose at f32 and bf16, each
    # with its launches, against the CPU port, and timed
    kernels += bf16_model_phases(counters, record)

    stamp("53-56")
    record["empty_profiles"] = len(EMPTY_PROFILES)
    print(f"profiler windows with no device event, profiled again: "
          f"{len(EMPTY_PROFILES)}")
    print(json.dumps(record))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
