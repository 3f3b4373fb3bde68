"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. card: name and power limit;
2. build: the native host library (g++) and kernels K1, K2, KT, KR, KM,
   KL, KS and KP, and KP's earlier design (nvcc, sm_90a; K1, KT and KR with -fmad=false; K2 and KR include
   csrc/fdct_core.cuh, K2's block core; K1, K2, KR and KS include
   csrc/mc_core.cuh, KS's row core) and the byte-SIMD rate
   measurement (csrc/simd_rate.cu), all from the sources in the checkout,
   in parallel;
3. K1 against its plain PyTorch versions on the card, exact equality. The
   decode entry (dequantize_idct_frames): random blocks at the decode
   path's per-plane shapes (115,200 and 28,800 at 1280x720 4:2:0, batch
   8) and their sum 172,800, int16 extremes included; as the encode scan
   launched it before the encode entry (14,400 and 3,600 blocks, one
   frame, at one qi row and at three: 43,200 and 10,800 blocks, qii 0-2),
   whose chroma launches end in a partial CTA; and the libtheora iDCT
   vectors. The encode entry (idct_recon_choose; reconstruction, SSD, qii,
   values and counts of the kept row against transforms.idct_recon_choose):
   random values at K = 1, 2 and 3 over 14,400 and 3,600 blocks (the 3,600
   launch ends in a partial CTA), with lambda scales drawn in [0.1, 8] and
   without, the edge classes first (an all-zero row, a DC-only row, int16
   extremes); K2 -> KT outputs of random residuals at K = 1 and 3
   (tools/bench_idct.py:kernel_chain_inputs); blocks whose rows tie in
   cost (the earlier row must win), and blocks whose lambda term lies
   within one float32 ulp of an integer, so that one rounding decides the
   row. CUDA-event times, each beside its bound (tools/bench_idct.py:
   k1_bound), its plain version and a device copy of the same bytes: the
   decode entry at 172,800 blocks and at 3 x 14,400; the encode entry at
   K = 3 and K = 1 over 14,400 blocks of K2 -> KT outputs, beside the
   chain it replaced (the decode entry over K x N pairs and the PyTorch
   ops after it, tools/bench_idct.py:parent_chain);
4. golden streams: BatchDecoder(device="cuda").decode_clip must equal
   libtheora's .ref.yuv output byte for byte; every frame of the six is
   coded below q47, so its planes filter through KL, three launches per
   frame whose limit is above 0, counted;
5. real-size decode: decode_clip(batch=8) of the 1280x720 test stream,
   every frame's SHA-256 against the committed list, a warm pass timed
   with K1's launch count reset just before it;
5b. postprocessing (pp_goldens, real_size_pp7): clip64x48_k8_q5 at pp 2
   and pp 7 through decode_clip and PacketDecoder(device="cuda") against
   libtheora's .pp2.yuv / .pp7.yuv byte for byte (KP once at pp 2, six
   times at pp 7, per batch of decode_clip and per packet); the slice's
   main path, the 1280x720 stream at pp 7 through decode_clip(batch=8)
   and PacketDecoder, every frame's SHA-256 against
   testdata/hd720_q56_k12_pp7.sha256 (the JAX host Decoder's at level
   7), warm decode_clip passes at pp 0 and pp 7 in turns with the counts
   reset before each (KP two launches per plane per batch at pp 7, 18
   per 24-frame pass, none at pp 0; the other kernels' counts equal; per
   packet two per plane per frame), their walls, host parse and device
   busy time, and KP's traced time and share of the device time in one
   traced pp 7 pass;
6. K2 against its plain version on the card: random residuals with the
   int16-safe extremes and random frame types at the encode path's
   per-plane shapes (14,400 and 3,600 blocks at 1280x720 4:2:0) and their
   sum 21,600, at K = 1, 2 and 3 qi rows of adaptive quantization's real
   lists (DC at the base qi), each row of a K-row launch also against a
   one-row launch at that row; the libtheora fDCT vectors; exact
   equality; CUDA-event times at 21,600 blocks at K = 1 and 3 beside
   their bounds (tools/bench_fdct.py) and a device copy of the same
   bytes;
6b. KT (the trellis) against its plain version (transforms.
   trellis_quantize) on the card, exact equality of the values, nonzero
   counts and DC-only flags: at three qi rows (the q56 inter triple) on
   K2's outputs at 14,400, 3,600 and 21,600 blocks, an inter frame with
   per-block lambda scales drawn in [0.1, 8] and an intra frame without;
   at one qi row, one launch per frame type as the encoder makes them
   (the frame's RD_LAMBDA lambda; intra blocks take acmin 3, inter blocks
   acmin 0): on K2's own outputs for random residuals at 14,400, 3,600
   and 21,600 blocks, an intra and an inter frame each; on the 1280x720
   clip's first frame, luma and chroma; on the edge classes (no nonzero
   AC value, one nonzero value at position 63 or at position 1, dense
   +-32767) among K2's outputs; on a launch without any nonzero AC value;
   on 1,500 blocks of coefficients up to +-32767; on the 97 blocks of
   testdata/vectors/trellis_order_cases.npz and the blocks of
   trellis_fma_cases.npz (fractional lambdas, as lambda 1 times per-block
   scales), one launch per (qi, frame type); CUDA-event times of the three-row inter launch at 14,400
   blocks, of K2's outputs at 14,400 and 3,600 blocks at one row, of the
   first frame's planes and of the launch without nonzero AC values, each
   beside its bound and its histogram of nonzero AC values per block
   (tools/bench_trellis.py), and of the plain version at 3 x 14,400;
6c. KR (the R/D quantizer of speed levels 2-4 and use_trellis=False) on
   the card, exact equality of the values, nonzero counts and DC-only
   flags. Its standalone entry (quantize_rd, the test hook) against its
   plain version (transforms.quantize_rd_rows): K2's outputs on random
   residuals at K = 1, 2 and 3 real qi lists over 14,400, 3,600 and
   21,600 blocks, intra and inter blocks mixed (each block takes its row's
   intra or inter lambda); the edge classes (a lone +-1 at position 1 and
   at position 63, +-1 pairs, no nonzero AC value, +-32767); the blocks of
   testdata/vectors/qrd_fma_cases.npz, one launch each. Its fused entry
   (fdct_quantize_rd, K2's block core and the same row step in one launch:
   the encode scan's) against its plain version (transforms.
   fdct_quantize_rd) and the K2 -> KR chain, on the same random residuals
   at K = 1, 2, 3 over 14,400, 3,600 (a partial CTA) and 21,600 blocks, and
   over 3 mesh segments of 14,400 blocks at K = 1, 2, 3
   (tools/bench_segments.py:segment_case). CUDA-event times
   (tools/bench_qrd.py): the fused entry at 14,400 blocks, K = 1 and 3, and
   3 segments x 14,400 at K = 3 beside the chain and K2 alone in turns,
   its bound (kr_fused_bound) and its plain version; the standalone entry
   at K = 1 and 3 beside its bound (kr_bound), its plain version, a device
   copy of the same bytes and KT on the same K2 outputs;
6d. KM (the encoder's ME plan, three launches per plan call) against its
   plain version (ops/me.py:plan_with_gold) on the card, all 11 outputs
   exactly equal (tools/bench_me.py:cases): the 1280x720 luma as
   encode_clip chunks it (8 frames, 7 rows, gold the keyframe) and the
   mesh's 24 frames at gop axis 3 (23 rows, gold each GOP's keyframe);
   720p synthetic frames built to tie (flat, period-4 stripes and their
   one-pixel roll, noise and noise rolled by (2, -5)) and noise rolled by
   (+-20, +-17), which saturates the MB search at +-15 and the 4MV blocks
   at +-13; byte extremes (a 0/255 checkerboard then its inverse, an
   all-0 frame then an all-255 one) and noise rolled to every residue of
   dx mod 4 in both directions (word alignment); the same at 176x144 (an
   odd number of MB rows) and 64x48 (every MB touches an edge). The issue
   rates of the byte SIMD instructions (bench_me.simd_rates, per SM per
   clock). CUDA-event times at 7 and 23 rows, each launch alone too,
   beside the bound (bench_me.km_bound), the bound at the measured rates
   (bench_me.km_bound_at) and the plain version. Every encode path
   below counts KM's launches: 3 per plan call (2 calls per 16-frame
   encode_clip, 3 per 24-frame transcode, 1 per mesh batch), none on the
   host Encoder's and the intra paths;
6e. KL (the loop filter and the UMV borders, one launch per plane or
   plane stack per frame step) against its plain version
   (ops/loopfilter.py:loop_filter_plane, then fill_borders) on the card,
   byte for byte over the whole padded plane, on tools/
   bench_loopfilter.py:cases: the 1280x720 4:2:0 luma and chroma planes,
   a 4:2:2 and a 4:4:4 chroma plane, a one-row and a one-column grid,
   limits 1, 2, 15 and 63, coded densities 0, 0.3, 0.6 and 1 and the
   patterns built for the corner writes (vE beside vL, one coded block at
   each corner and all four, a checkerboard, stairs), the same at the
   kernel's tile seams (columns 29-32, 59-61 and the last tile's) on the
   720p planes and a 61-column grid, low-contrast, uniform and 0/255
   pixels, and three chroma planes in one launch with limits [5, 0, 31];
   the input left as it was. CUDA-event times at the 720p luma and
   chroma planes and a frame's three planes, each beside the bound
   (bench_loopfilter.kl_bound), the plain version, a device copy of the
   same bytes and an empty kernel's launch, and in turns with the
   earlier design (tools/kl_row_ctas.cu) alone and followed by
   fill_borders, the work KL replaces. Every path below counts KL's
   launches: one per plane (stack) per frame step whose limit is above
   0, none at q >= 47;
6f. KS (MC, the skip test and the plane's assembly with its borders:
   ops/mc_cuda.py, csrc/mc.cu) against its plain versions (ops/mc.py)
   on the card, every output byte for byte, the planes' padding
   included, on tools/bench_mc.py:cases: mc_residual, skip_place (its
   split form skip_rows / place_rows over a frag group) and mc_recon on
   the 1280x720 4:2:0 luma and chroma planes, a 4:2:2 and a 4:4:4 chroma
   plane, G = 1 and 3 mesh segments, a frag group's fragment-id subset
   (clamped pads), MVs at the padding's extremes in every corner, every
   reference and half-pel flag, prev and gold one buffer, skip ties and
   lambdas one float32 ulp from an integer product, key and inter steps,
   unfiltered (borders) and filtered (zero padding) steps, and the split
   form over 2 ranks against skip_place; one launch per call, the inputs
   left as they were. Then KS fused into the encode scan's kernels
   (bench_mc.check_fused): K2's entry with KS's MC as its head
   (fdct_cuda.mc_fdct_quantize), KR's (qrd_cuda.mc_fdct_quantize_rd) and
   K1's entry with KS's MC, skip test and plane assembly around the
   chooser (idct_cuda.mc_idct_recon_skip), each against its plain chain
   (mc_residual, then K2 / KR / K1 and skip_place or skip_rows, as plain
   versions) and its kernel chain, every output byte for byte (the plane
   and its padding, or the rows; qout, coded, qii), on
   bench_mc.fused_cases: the same planes, G = 1, 3 with prev and gold one
   buffer, and a frag group's share, K = 1, 2 and 3, the trellis and the
   R/D path, key and inter steps, borders on and off, engineered blocks
   whose skip test ties at lambda 8 and turns on one float32 ulp of it.
   CUDA-event times of each entry at the 720p luma and 4:2:0 chroma
   shapes beside its bound (bench_mc.ks_bound), the plain chain, a device
   copy moving the same bytes and an empty kernel's launch; the fused
   entries in turns with the chains they replaced (bench_mc.timed_fused,
   beside bench_mc.fused_bound). Every path below counts KS's launches:
   none of its own on an encode without a frag group (its work runs in
   the fused entries, which count once per plane per frame step), its
   place entry once per plane per frame step on a frag group's ranks,
   mc_recon once per plane per decoded frame (the decodes, the
   transcode's decode, the per-packet decoder, the host Encoder's closed
   loop), none on the intra paths;
6g. KP (the decoder's out-of-loop postprocessor, deblock + dering:
   ops/postproc_cuda.py, csrc/postproc.cu; a deblock and a dering launch
   per plane per batch) against its plain version (ops/postproc.py:
   postprocess_plane, on the same inputs on the CPU) byte for byte: its
   one-frame entry on tools/bench_pp.py:cases (random 720p luma, 4:2:0,
   4:2:2 and 4:4:4 chroma planes at every pp level's plane and strength
   choice, one-row and one-column planes, grids with variances on each
   dering threshold and one either side of it; each call contiguous and
   into a padded plane's strided image, the inputs left as they were) and
   on the long-chain frame (frame 0 of the JAX package's 720p benchmark
   clip, bench.py:gen_frames, as a qi-5 keyframe from GopEncoder on the
   card, decoded by PacketDecoder at pp 7 against the plain version on
   its pp 0 planes), with its count of three-pass blocks, its longest
   chain of filtered neighbours, its path in the kernel's block order and
   its dependency chain; its frame-axis entry on bench_pp.frame_cases
   (F = 1, 3 and 8, dering off, on and strong mixed, a frame without pp
   in the middle, padded planes' views, 4:2:0, 4:2:2 and 4:4:4 chroma,
   rows waiting on filtered blocks above). CUDA-event times in turns
   with KP's earlier design (tools/kp_block_serial.cu, built from the
   checkout) of the deblock and the dering launches at the keyframe's
   and a raw frame's 720p luma and chroma and of an 8-frame luma batch,
   beside the bound (bench_pp.kp_bound and kp_bound_batch: the call's
   own bytes, or the dependency chain at one pixel update's latency as
   the kernel's step probe measures it, whichever is longer), the plain
   version, a device copy of the plane and as many empty launches;
7. small encodes: GopEncoder(device="cuda", adaptive_quant=False) at
   64x48 for pixel formats 0, 2 and 3; adaptive_quant=True on the 96x64
   half-smooth, half-noise clip (the qi triple) and "auto" on the
   half-smooth, half-texture clip (the triple with per-block lambda
   scales); every packet's SHA-256 against the list the JAX
   TpuGopEncoder made (testdata/make_hd720_enc.py); the 96x64 clips must
   code blocks at a non-base qi, and their closed loops must equal
   BatchDecoder(device="cuda"); the rest of the encoder's settings against
   their lists: speed levels 2 and 4 at 64x48, use_trellis=False on both
   96x64 clips (KR at three qi rows), auto_keyframe on a clip with a
   scene cut, CBR at 60 kbit/s (the qi must move) and a 2-pass encode
   (packets and the pass-1 metrics blob); the mesh at gop axis 4 on the
   scene-cut clip under CBR (mesh64x48_cut_cbr_enc, qi 40 and below): KL
   launched over the 4 GOPs' planes with limits above 0;
8. real-size encodes: 16 frames of the 1280x720 clip, a keyframe every 8
   frames, clip_batch 8, at q48 with adaptive_quant=False and, the main
   path, at q56 with the default adaptive_quant="auto" (the qi triple on
   every frame): every packet's SHA-256 against the JAX encoder's list;
   the first GOP's closed-loop reconstruction against
   BatchDecoder(device="cuda") on its packets; a warm encode_clip pass
   timed with the K1, K2 and KT launch counts reset just before it (K1's
   encode entry, K2 and KT must each launch once per plane per frame, 48
   times, and K1's decode entry not at all), blocks at a non-base qi at
   q56, and its PSNR against the source; the same at q48 and speed level
   2 (the R/D quantizer: KR's fused entry 48 launches, K2 and KT none,
   KR's standalone entry none); and a 2-pass encode
   of the 16 frames at 2 Mbit/s with a 16-frame rate buffer: packets and
   metrics blob against the list, more than one qi among the frames, the
   first GOP's closed loop at its frames' qis, and a warm pass timed with
   the launch counts reset (pass 1 and pass 2: 96 launches of K1's
   encode entry, K2 and KT, none of KR; KL three per frame whose qi's
   limit is above 0, in each pass, from the frame qis the two passes
   report); its packets decoded on the card, through KL.

9. the paths of the stages: (a) the device-resident transcode
   (transcode_device) of the 1280x720 test stream's 24 data packets,
   decode batches of 8 feeding the encoder on the card, qi 48,
   adaptive_quant "auto": the 27 packets against the JAX
   transcode_device's list, a warm pass with the launch counts reset
   (K1's decode entry 9, its encode entry, K2 and KT 72 each) and every
   device->host copy counted at the port's copy calls, none the size of
   a decoded frame; (b) the 720p q56 "auto" encode through the pipelined
   encode_clip and stage by stage through dispatch_me, complete_dispatch
   and finish_gop in turns, 3 pairs, the enqueue stages under
   torch.cuda.set_sync_debug_mode("error") (whether an explicit event
   wait trips it is printed, and such a wait is then kept outside), every
   run's 19 packets against the list; the 720p decode's dispatch_batch
   under the same mode; one chunk's coefficient download, sparse against
   dense, timed; (c) the 720p stream decoded packet by packet
   (PacketDecoder) against its SHA-256 list, ms per frame beside
   decode_clip's, K1's decode entry once per plane per frame.

10. the mesh GOP encoder (parallel/gop.py, the gop axis as a batch
   dimension on one card): (a) K2, KT, KR's fused entry and K1's encode
   entry over 3 segments of 14,400 blocks (a 720p luma plane per GOP), a
   distinct qi triple, lambdas and lambda scales per segment
   (tools/bench_segments.py), each kernel's one launch equal to its plain
   version and to 3 launches of one segment, exactly, and timed beside
   them; (b) the slice's main path, encode_clip_mesh of the 16 720p frames
   at q56 "auto", keyframe every 8, gop axis 2: the 19 packets against
   hd720_q56_k8_aq_enc.sha256 (the sequential encoder's list, which JAX's
   mesh at gop axis 2 also gives: testdata/make_hd720_enc.py CHECKS), a
   warm pass with the counts reset (K1's encode entry, K2, KT 24 each),
   and KR's path: the two GOPs at q48 speed 2 in one encode_gops batch
   against hd720_q48_k8_sp2_enc.sha256 (K1 and KR 24 each, K2 and KT
   none);
   (c) 24 720p frames at q48 "auto", keyframe every 8, through
   encode_clip_mesh on a gop axis of 3 and the sequential encode_clip in
   turns, 3 pairs: 27 packets equal both ways, walls, each kernel's
   launches (24 against 72) and, from one traced pass each way, device
   kernels per plane per frame. No claim.
   (d) the mesh over torch.distributed ranks (parallel/ranks.py): two
   local "gloo" processes, both on cuda:0, at {gop 1, frag 2} (each rank
   encodes half of every frame's fragments and the ranks gather the
   reconstructed blocks at every frame step) on the 16 720p frames at q56
   "auto" against hd720_q56_k8_aq_enc.sha256 and at q48 speed 2 against
   hd720_q48_k8_sp2_enc.sha256, and at {2, 1} (one GOP per rank) at q48
   "off" against hd720_q48_k8_enc.sha256: every packet on every rank;
   per rank the launches of a warm pass (K1's, K2's and KR's fused
   entries, KT, KM and KS's entries, exact and above 0 where the path
   runs them: at {1, 2} KS's place_rows once per plane per frame step, at
   {2, 1} none of KS's), the walls,
   the
   gather's time per plane per frame step and its route (pinned host
   buffers: gloo takes no card tensors), and its transport alone on one
   luma step's bytes.

11. the all-keyframe batch encoder and the pipeline cores: (a)
   pipeline.intra_encode_core on 24 720p frames at qi 48, luma [24,
   14400] blocks in one call and Cb+Cr [48, 3600] in another (as the JAX
   package's bench.py times its compute core): each call equal to its
   plain version on the card, one K2 and one K1 decode-entry launch per
   call, the two calls timed with CUDA events as Mpix/s over 24 x
   1,382,400 pixels beside K2 and K1 alone at those block counts and their
   bounds; inter_encode_core and recon_core at 14,400 blocks against their
   plain versions; (b) BatchIntraEncoder(device="cuda") on the 16 720p
   frames at q48 as one batch: the 19 packets against
   hd720_intra_q48_enc.sha256 (the JAX host Encoder's), a warm pass with
   the counts reset (K2 3 launches, one per plane index; K1, KT, KR
   none), its wall split into the device part and the host's per-frame
   stages, PSNR through the port's decoder; (c) the test cases'
   BatchIntraEncoder packets on the card against intra64x48_enc,
   intra96x64_aq_enc and F5's intra64x48_f5_enc (rate control: K2 per
   frame at its own qi).

12. the host Encoder (encode/encoder.py), its inter path with the closed
   loop decoded on the card (PacketDecoder: K1's decode entry, MC, loop
   filter, borders): (a) the 16 720p frames at q48 "auto", a keyframe
   every 8, through Encoder(device="cuda"): the 19 packets against
   hd720_host_q48_k8_enc.sha256 (the JAX host Encoder's), a warm pass with
   the counts reset (K1's decode entry, at most 3 launches per decoded
   packet, and KS's, 3 per decoded packet), its wall split into ME and
   mode decision, the closed loop's decode and download, and transform,
   trellis and packing, PSNR;
   (b) parallel/transcode.py on two threads over the same frames, against
   the same list; (c) parallel/distributed.py in two local "gloo"
   processes both on the card, rank 0's packets against the list, the
   workers' K1 counts summed; (d) the th_* encode API's main path:
   compat.th_enc_ctx(device="cuda") under a target bitrate, the 16 720p
   frames, a keyframe every 8 (TH_ENCCTL_SET_KEYFRAME_FREQUENCY_FORCE),
   info quality 0, 300 kbit/s (testdata/make_compat_enc.py:run_hd720):
   a first pass, then a warm pass with the counts reset, every packet
   against hd720_compat_cbr_enc.sha256 (the JAX th_enc_ctx's), the
   dropped frames (0-byte packets) counted, at least one, and the
   closed loop's launches against the frames it decoded (K1's decode
   entry 1 to 3 per frame, KS's mc_recon 3 per frame, KL 3 per frame
   that filters: above 0, as every frame is coded at qi 0; no other
   kernel), the wall split; (e) every make_compat_enc case (th_enc_ctx
   at VBR, CBR with drops, drops off with a mid-stream bitrate and rate
   buffer, VP3 with VP31's tables and its drop frames, VP31's
   quantization parameters, other Huffman codes, another encoder's setup
   header, the dup count (F11), the 2-pass ctl protocol, the legacy
   theora_* round trip) on the card against compat64x48_enc.sha256, the
   VP3 stream decoded by PacketDecoder on the card equal to the plain
   path's, drop frames included, the same count check; (f)
   `tools.enc --host` (the host Encoder, closed loop on the card) at -b
   with drops, --drop-frames 0 and --two-pass --rate-buffer 12 on the
   64x48 clip cut to 60x44, each .ogv against compat_cli.sha256 (the JAX
   CLI's default branch), the same count check; (g) every 64x48 and
   96x64 HOST_CASES case against host64x48_enc and host96x64_aq_enc (q40
   filters in the closed loop); (h) `tools.enc -j 2` (two spawned
   processes, each on the card) on the 64x48 clip against its lines of
   host64x48_enc.

13. the tools (theora_tpu_torch/tools/), each on the card: (a) the
   slice's main path, `qualitysweep --size 1280x720 --frames 16 --qis
   24,48 --content smooth,textured --skip ref`, the counts reset just
   before it: every host-column and device-column stream against
   sweep720_host.sha256 and sweep720_dev.sha256 (the JAX tool's
   encoders', testdata/make_tools.py), each stream's BatchDecoder frames
   equal to the sweep's PacketDecoder frames, the rows' PSNR and SSIM
   repeated on the card and against the CPU to 1e-9, the walls; (b)
   crosscheck's --gop, --fuzz and --synth trials (seed 24, 6 each, up to
   96x80) and a fuzz stream with damaged packets: the card's
   PacketDecoder against the CPU's (the plain versions), the same
   statuses and bytes, KP, KL and KS's mc_recon launched; (c) collect
   with mode_rd on 8 frames of the 720p source at qi 24 and 48: packets
   and per-frame rows against collect720_moderd.sha256 (the JAX host
   Encoder's); (d) profile --mode encode and decode: each Chrome trace
   carries the codec's record_function labels; (e) play --stats-only -o
   on the 720p test stream against hd720_q56_k12.sha256; (f) enc -a on
   both branches where libvorbis loads (else a line says it is absent).
   Every part's launches by kernel.

Then one JSON line listing the eight kernels (times and bounds, K1's at
both entries, KS's at its three and in the fused entries; launches on the 720p decode, each 720p
encode path, the transcode, the per-packet decode, the mesh, the mesh
over ranks (per path and per rank) and the host Encoder's paths (the
th_* encode API's among them, KL's too), KL's
and KS's also on the golden decodes and the 2-pass packets' decode, KL's
on the small mesh;
for K1, K2, KT and KR the one launch over 3 segments beside 3 launches;
KP's on the 720p decode at pp 7, by batch and per packet, and the pp
goldens, its traced time per pp 7 pass and its times in turns with its
earlier design; every kernel's launches on each tool path of 13, the
sweep's counted in "launches"), the card's name and power limit from nvidia-smi, and {"ok": true,
"device": {...}}. Imports nothing of JAX or theora_tpu.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
TESTDATA = os.path.join(ROOT, "testdata")
GOLDEN = ("cif_k4_q40", "cif_cbr", "clip64x48_k8_q5", "crop80x64",
          "clip422", "clip444")
HD_NAME = "hd720_q56_k12"


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> tuple[str, str]:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[card] {name} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    return name, smi


def build() -> None:
    from theora_tpu_torch import native
    from theora_tpu_torch.ops import fdct_cuda, idct_cuda, loopfilter_cuda, \
        mc_cuda, me_cuda, postproc_cuda, qrd_cuda, trellis_cuda
    from theora_tpu_torch.ops.cuda_build import nvcc_build
    from theora_tpu_torch.tools import bench_me, bench_pp

    def timed(fn):
        t0 = time.perf_counter()
        path = fn()
        return path, time.perf_counter() - t0

    kp_parent = postproc_cuda._SO.replace(".so", "_parent.so")
    with concurrent.futures.ThreadPoolExecutor(11) as ex:
        jobs = {"native (g++)": ex.submit(timed, native.build),
                "K1 (nvcc sm_90a, -fmad=false)": ex.submit(
                    timed, idct_cuda.build),
                "K2 (nvcc sm_90a)": ex.submit(timed, fdct_cuda.build),
                "KT (nvcc sm_90a, -fmad=false)": ex.submit(
                    timed, trellis_cuda.build),
                "KR (nvcc sm_90a, -fmad=false)": ex.submit(
                    timed, qrd_cuda.build),
                "KM (nvcc sm_90a)": ex.submit(timed, me_cuda.build),
                "KL (nvcc sm_90a)": ex.submit(timed, loopfilter_cuda.build),
                "KS (nvcc sm_90a)": ex.submit(timed, mc_cuda.build),
                "KP (nvcc sm_90a)": ex.submit(timed, postproc_cuda.build),
                "KP's earlier design (nvcc sm_90a)": ex.submit(
                    timed, lambda: nvcc_build(bench_pp.PARENT_SRC,
                                              kp_parent)),
                "byte-SIMD rates (nvcc sm_90a)": ex.submit(
                    timed, bench_me.simd_build)}
        for what, job in jobs.items():
            path, dt = job.result()
            log(f"[build] {what}: {dt:.2f}s -> {os.path.relpath(path, ROOT)}")
    for k, so in (("K1", idct_cuda._SO), ("K2", fdct_cuda._SO),
                  ("KT", trellis_cuda._SO), ("KR", qrd_cuda._SO),
                  ("KM", me_cuda._SO), ("KL", loopfilter_cuda._SO),
                  ("KS", mc_cuda._SO)):
        with open(so + ".log") as f:
            for line in f.read().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[build] {k} ptxas: {line.strip()}")
    for k, so in (("KP", postproc_cuda._SO),
                  ("KP's earlier design", kp_parent)):
        for line in bench_pp.ptxas_report(so + ".log"):
            log(f"[build] {k} ptxas: {line}")


def _vector_inputs(device):
    """libtheora's iDCT cases (natural-order coefficients x, outputs y)
    as K1 inputs: zig-zag coefficients, unit dequant, no DC-only."""
    from theora_tpu_torch.constants import ZIGZAG_TO_NAT

    rec = np.dtype([("x", "<i2", 64), ("zzi", "<i4"), ("y", "<i2", 64)])
    cases = np.fromfile(os.path.join(TESTDATA, "vectors", "idct_cases.bin"),
                        dtype=rec)
    x = cases["x"].astype(np.int16)
    n = len(x)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    inputs = (
        t(x[:, ZIGZAG_TO_NAT]), t(x[:, 0]),
        t(np.ones((1, 3, 2, 64), np.int16)), t(np.zeros(n, np.int32)),
        t(np.zeros(n, np.uint8)), t(np.zeros(n, np.uint8)),
        t(np.zeros(n, bool)),
    )
    return inputs, cases["y"].astype(np.int16)


def _recon_cases(rng, device):
    """(label, encode-entry arguments) of K1's encode entry: random values
    (tools/bench_idct.py:recon_inputs, the edge classes first: an all-zero
    row, a DC-only row, int16 extremes) at K = 1, 2 and 3 over 14,400 and
    3,600 blocks (a 1280x720 luma and chroma plane; 3,600 ends in a
    partial CTA), with lambda scales in [0.1, 8] and without; kernel K2's
    and KT's outputs for random residuals at K = 1 and 3 (scales at 3);
    rows that tie in cost; lambda terms within one float32 ulp of an
    integer."""
    from theora_tpu_torch.tools import bench_idct as bi

    for n in (14400, 3600):
        for k in (1, 2, 3):
            for scales in (True, False):
                yield (f"random values, {k} x {n} blocks, lambda scales "
                       f"{'in [0.1, 8]' if scales else 'none'}",
                       bi.recon_args(bi.recon_inputs(rng, n, k, scales),
                                     device))
        for k in (1, 3):
            yield (f"K2 -> KT outputs of random residuals, {k} x {n} "
                   f"blocks", bi.kernel_chain_inputs(rng, n, k, device,
                                                     k == 3))
    yield ("rows that tie in cost, 3 x 14400 blocks, lambda scales",
           bi.recon_args(bi.tie_inputs(rng, 14400), device))
    yield ("rows that tie in cost, 3 x 3600 blocks, no lambda scales",
           bi.recon_args(bi.tie_inputs(rng, 3600, False), device))
    yield ("lambda terms within one float32 ulp of an integer, 2 x 14400 "
           "blocks", bi.recon_args(bi.ulp_inputs(rng, 14400), device))


def kernel_vs_plain(device) -> dict:
    from theora_tpu_torch.ops import idct_cuda, transforms
    from theora_tpu_torch.tools import bench_idct as bi
    from theora_tpu_torch.tools.bench_trellis import event_ms

    rng = np.random.default_rng(20261016)
    # The main path launches K1's decode entry once per plane per batch of
    # 8 frames: 8 * 14400 luma and 8 * 3600 blocks per chroma plane at
    # 1280x720 4:2:0. Check those shapes and their sum, 172,800.
    err = 0
    for n in (8 * 14400, 8 * 3600, 8 * (14400 + 2 * 3600)):
        args = bi.decode_inputs(rng, n, 8, device)
        got = idct_cuda.dequantize_idct_frames(*args)
        want = transforms.dequantize_idct_frames(*args)
        torch.cuda.synchronize()
        err = max(err, int((got.int() - want.int()).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"K1 != plain on {n} random blocks "
                                 f"(max |d| {err})")
    # The decode entry as the encode scan launched it before the encode
    # entry: 14,400 luma blocks and 3,600 per chroma plane (whose last CTA
    # is partial) at one row; 14,400 x 3 = 43,200 with adaptive
    # quantization's triple, qii 0-2.
    for ne, k in ((14400, 1), (3600, 1), (14400, 3), (3600, 3)):
        eargs = bi.encode_inputs(rng, ne, device, k)
        got = idct_cuda.dequantize_idct_frames(*eargs)
        want = transforms.dequantize_idct_frames(*eargs)
        torch.cuda.synchronize()
        err = max(err, int((got.int() - want.int()).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"K1 != plain on {k} x {ne} encode-path "
                                 f"blocks (max |d| {err})")
    vin, vy = _vector_inputs(device)
    vgot = idct_cuda.dequantize_idct_frames(*vin).cpu().numpy()
    vplain = transforms.dequantize_idct_frames(*vin).cpu().numpy()
    if not (np.array_equal(vgot, vy) and np.array_equal(vplain, vy)):
        raise AssertionError("K1 or plain != libtheora idct_cases.bin")
    err = max(err, int(np.abs(vgot.astype(np.int32) - vy).max()))
    log(f"[k1] decode entry: random 115200, 28800 and {n} blocks (decode "
        f"shapes), 14400 and 3600 blocks at one qi row and 3 x 14400, 3 x "
        f"3600 at three (the earlier encode shapes): kernel == plain; "
        f"idct_cases.bin {len(vy)} cases: kernel == plain == libtheora; "
        f"max |err| {err} (tolerance 0: exact)")
    # The encode entry: all five outputs equal the plain version's.
    for label, rargs in _recon_cases(rng, device):
        got = idct_cuda.idct_recon_choose(*rargs)
        want = transforms.idct_recon_choose(*rargs)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            err = max(err, int((g.int() - w.int()).abs().max()))
            if not torch.equal(g, w):
                raise AssertionError(f"K1 encode entry != plain on {label} "
                                     f"(max |d| {err})")
        rows = torch.bincount(want[2].long(), minlength=3).tolist()
        log(f"[k1] encode entry, {label}: kernel == plain (recon, SSD, qii, "
            f"values, counts); rows kept {rows}; "
            f"{int(rargs[1].sum())} DC-only (row, block) pairs")
    log(f"[k1] max |err| {err} over both entries (tolerance 0: exact)")

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)

    def copy_ms(nbytes):
        """A device copy that reads and writes nbytes in all: what the
        card's memory actually sustains for K1's traffic."""
        src = torch.empty(nbytes // 2, dtype=torch.uint8, device=device)
        dst = torch.empty_like(src)
        return event_ms(lambda: dst.copy_(src), 50, flush)

    def report(what, entry, targs, fn, plain, chain=None):
        ms = event_ms(fn, 50, flush)
        plain_ms = event_ms(plain, 5, flush)
        b = bi.k1_bound(entry, targs)
        cms = copy_ms(b["bytes"])
        out = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b["bound_ms"],
               "bound_by": b["bound_by"], "bytes": b["bytes"],
               "copy_ms": cms}
        extra = ""
        if chain is not None:
            out["replaced_chain_ms"] = event_ms(chain, 50, flush)
            extra = (f"; the chain it replaced (decode entry over K x N "
                     f"pairs + PyTorch ops) {out['replaced_chain_ms']:.4f} "
                     f"ms")
        log(f"[k1] time, {what}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms; bound {b['bound_ms']:.4f} ms by {b['bound_by']} "
            f"({b['bytes']} B -> {b['bytes_ms']:.4f} ms at 3.35 TB/s; "
            f"{b['int32_ops']} int32 + {b['float32_ops']} float32 ops -> "
            f"{b['ops_ms']:.4f} ms); kernel at {100 * b['bound_ms'] / ms:.2f}%"
            f" of its bound; a device copy of the same bytes takes "
            f"{cms:.4f} ms{extra}; no single PyTorch call computes this "
            f"integer iDCT (library_ms null)")
        return out

    timed = {}
    for what, targs in (("decode", args),
                        ("decode entry, 3 x 14400",
                         bi.encode_inputs(rng, 14400, device, 3))):
        timed[what] = report(
            f"{what}, {targs[0].shape[0]} blocks", "decode", targs,
            lambda targs=targs: idct_cuda.dequantize_idct_frames(*targs),
            lambda targs=targs: transforms.dequantize_idct_frames(*targs))
        timed[what]["blocks"] = targs[0].shape[0]
    for k in (3, 1):
        rargs = bi.kernel_chain_inputs(rng, 14400, k, device, k == 3)
        timed[k] = report(
            f"encode entry, K = {k}, 14400 blocks (K2 -> KT outputs)",
            "encode", rargs,
            lambda rargs=rargs: idct_cuda.idct_recon_choose(*rargs),
            lambda rargs=rargs: transforms.idct_recon_choose(*rargs),
            bi.parent_chain(idct_cuda.dequantize_idct_frames, rargs))
        timed[k].update(blocks=14400, rows=k)
    enc = timed[3]
    return {
        "name": "dequant_idct", "route": "cuda",
        "source": "theora_tpu_torch/csrc/idct.cu",
        "replaces": "theora_tpu/ops/pallas_kernels.py:175",
        "launches": None, "max_abs_err": err, "ms": enc["ms"],
        "plain_ms": enc["plain_ms"], "bound_ms": enc["bound_ms"],
        "bound_by": enc["bound_by"], "library_ms": None,
        "timed_entry": "idct_recon_choose", "timed_blocks": 14400,
        "timed_rows": 3, "replaced_chain_ms": enc["replaced_chain_ms"],
        "encode_entry_one_row": timed[1], "decode_entry": timed["decode"],
        "decode_entry_encode_rows": timed["decode entry, 3 x 14400"],
    }


def _open(name: str):
    from theora_tpu_torch.decode.batch import BatchDecoder
    from theora_tpu_torch.headers import parse_info_header, \
        parse_setup_header

    if name.endswith(".ogv"):
        from theora_tpu_torch.ogg import demux_stream

        with open(os.path.join(TESTDATA, name), "rb") as f:
            pkts = demux_stream(f.read())
    else:
        from theora_tpu_torch.tpkt import read_tpkt

        pkts = read_tpkt(os.path.join(TESTDATA, name))
    info = parse_info_header(pkts[0].data)
    setup = parse_setup_header(pkts[2].data)
    return BatchDecoder(info, setup, device="cuda"), [p.data for p in pkts[3:]]


def _frame_bytes(frame) -> bytes:
    return b"".join(np.ascontiguousarray(p).tobytes() for p in frame)


def _kl_frames(setup, datas) -> int:
    """The data packets whose frame filters: not a dup, and its qi's
    loop-filter limit above 0 (KL launches once per plane of each)."""
    lfl = setup.qinfo["loop_filter_limits"]
    return sum(1 for d in datas if d and lfl[d[0] & 0x3F] > 0)


def _live(datas) -> int:
    """The data packets that decode a frame (not a dup): KS's decode
    entry launches once per plane of each."""
    return sum(1 for d in datas if d)


def golden_streams() -> tuple:
    """Phase 4; returns KL's and KS's launches over the six streams."""
    from theora_tpu_torch.ops import idct_cuda, loopfilter_cuda, mc_cuda

    total = ks_total = 0
    for name in GOLDEN:
        dec, data = _open(f"{name}.tpkt")
        before = idct_cuda.dequantize_idct_frames.launches
        kl0 = loopfilter_cuda.loop_filter_plane.launches
        ks0 = mc_cuda.mc_recon.launches
        outs = dec.decode_clip(data, batch=8)
        launched = idct_cuda.dequantize_idct_frames.launches - before
        kl = loopfilter_cuda.loop_filter_plane.launches - kl0
        ks = mc_cuda.mc_recon.launches - ks0
        ref = np.fromfile(os.path.join(TESTDATA, f"{name}.ref.yuv"),
                          np.uint8).reshape(len(data), -1)
        bad = [i for i, o in enumerate(outs)
               if _frame_bytes(o) != ref[i].tobytes()]
        if len(outs) != len(data) or bad:
            raise AssertionError(f"{name}: frames {bad} differ from .ref.yuv")
        if launched == 0:
            raise AssertionError(f"{name}: K1 was not launched")
        filtered = _kl_frames(dec.setup, data)
        if kl != 3 * filtered or kl == 0:
            raise AssertionError(f"{name}: KL launches {kl}; expected 3 per "
                                 f"filtered frame, {filtered} frames")
        live = _live(data)
        if ks != 3 * live:
            raise AssertionError(f"{name}: KS decode-entry launches {ks}; "
                                 f"expected 3 per decoded frame, {live}")
        total += kl
        ks_total += ks
        log(f"[golden] {name}: {len(outs)} frames byte-identical to "
            f".ref.yuv; K1 launches {launched}; KL launches {kl} ({filtered} "
            f"frames below q47); KS launches {ks} ({live} decoded frames)")
    return total, ks_total


def real_size(smi: str) -> dict:
    """The 720p batch decode against its SHA-256 list; a warm pass with
    every kernel count reset just before it. Returns the counts read just
    after (_counts_all): K1's decode entry, KS's decode entry (3 per
    frame), and 0 for every other kernel."""
    with open(os.path.join(TESTDATA, f"{HD_NAME}.sha256")) as f:
        want = f.read().split()

    def check(outs, what):
        got = [hashlib.sha256(_frame_bytes(o)).hexdigest() for o in outs]
        bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        if len(got) != len(want) or bad:
            raise AssertionError(f"{HD_NAME} {what}: frames {bad} differ")

    dec, data = _open(f"{HD_NAME}.ogv")
    check(dec.decode_clip(data, batch=8), "first pass")
    # Warm pass: a fresh decoder on the same process, K1 count from 0.
    dec, data = _open(f"{HD_NAME}.ogv")
    dec.device_spans = []
    _reset_counts()
    t0 = time.perf_counter()
    outs = dec.decode_clip(data, batch=8)
    wall = time.perf_counter() - t0
    launches = _k1_decode_only("720p decode")
    ks = _ks_decode_only("720p decode", 3 * _live(data))
    check(outs, "warm pass")
    if launches == 0:
        raise AssertionError("K1 was not launched on the main path")
    torch.cuda.synchronize()
    dev_s = sum(a.elapsed_time(b) for a, b in dec.device_spans) / 1e3
    nf = len(outs)
    mpix = nf * 1280 * 720 * 1.5 / 1e6
    log(f"[720p] {nf} frames, all {len(want)} SHA-256 match; warm pass "
        f"{wall:.4f} s = {nf / wall:.2f} frames/s = {mpix / wall:.2f} "
        f"Mpix/s; host parse {dec.host_parse_s:.4f} s; device spans "
        f"(CUDA events) {dev_s:.4f} s over {len(dec.device_spans)} "
        f"batches; K1 launches {launches}, KS launches {ks} (decode entry), "
        f"no other kernel | {smi}")
    return _counts_all()


def _load_testdata(name: str):
    """A generator module of testdata/ by path (numpy only at import)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(TESTDATA, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def k2_vs_plain(device) -> dict:
    from theora_tpu_torch.encode import aq
    from theora_tpu_torch.ops import fdct_cuda, transforms
    from theora_tpu_torch.tools import bench_fdct as bf
    from theora_tpu_torch.tools.bench_trellis import event_ms

    rng = np.random.default_rng(20261017)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    # The encode path launches K2 once per plane per frame: 14,400 luma
    # and 3,600 blocks per chroma plane at 1280x720 4:2:0, and their sum,
    # at K = 1, 2 and 3 qi rows: real qi lists of adaptive quantization
    # (the q56 inter triple, the q63 pair), DC at the base qi.
    lists = {1: [48], 2: aq.qi_triple(True, 63, 1, 0),
             3: aq.qi_triple("auto", 56, 1, 0)}
    err = 0
    for n, pli in ((14400, 0), (3600, 1), (21600, 2)):
        res = t(bf.random_residuals(rng, n))
        inter = t(rng.integers(0, 2, n).astype(np.uint8))
        single = {}
        for k, qis in lists.items():
            deq = t(bf.triple_rows(qis, pli))
            got = fdct_cuda.fdct_quantize(res, deq, inter)
            want = transforms.fdct_quantize(res, deq, inter)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                err = max(err, int((g.int() - w.int()).abs().max()))
                if not torch.equal(g, w):
                    raise AssertionError(f"K2 != plain at K = {k} on {n} "
                                         f"random blocks (max |d| {err})")
            # Row r of a K-row launch equals a one-row launch at row r.
            for r in range(k):
                one = single.setdefault(
                    qis[r], fdct_cuda.fdct_quantize(res, deq[r:r + 1],
                                                    inter))
                if not (torch.equal(one[0][0], got[0][r])
                        and torch.equal(one[1], got[1])):
                    raise AssertionError(f"K2 row {r} of K = {k} != its "
                                         f"one-row launch on {n} blocks")
    rec = np.dtype([("x", "<i2", 64), ("y", "<i2", 64)])
    cases = np.fromfile(os.path.join(TESTDATA, "vectors", "fdct_cases.bin"),
                        dtype=rec)
    vin = (t(cases["x"]), torch.full((1, 2, 64), 8, dtype=torch.int16,
                                     device=device),
           torch.zeros(len(cases), dtype=torch.uint8, device=device))
    vq, vd = fdct_cuda.fdct_quantize(*vin)
    pq, pd = transforms.fdct_quantize(*vin)
    vd = vd.cpu().numpy()
    if not (np.array_equal(vd, cases["y"]) and torch.equal(vq, pq)
            and np.array_equal(pd.cpu().numpy(), cases["y"])):
        raise AssertionError("K2 or plain != libtheora fdct_cases.bin")
    err = max(err, int(np.abs(vd.astype(np.int32) - cases["y"]).max()))
    log(f"[k2] random 14400, 3600 and 21600 blocks at K = 1 {lists[1]}, "
        f"2 {lists[2]} and 3 {lists[3]}: kernel == plain (quantized rows "
        f"and DCT), each row == its one-row launch; fdct_cases.bin "
        f"{len(cases)} cases: kernel DCT == plain == libtheora; max |err| "
        f"{err} (tolerance 0: exact)")

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    timed = {}
    for k in (1, 3):
        kargs = (res, t(bf.triple_rows(lists[k], 2)), inter)
        ms = event_ms(lambda: fdct_cuda.fdct_quantize(*kargs), 50, flush)
        plain_ms = event_ms(lambda: transforms.fdct_quantize(*kargs), 5,
                            flush)
        b = bf.k2_bound(kargs)
        src = torch.empty(b["bytes"] // 2, dtype=torch.uint8, device=device)
        dst = torch.empty_like(src)
        copy_ms = event_ms(lambda: dst.copy_(src), 50, flush)
        log(f"[k2] time at K = {k}, {n} blocks: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms; bound {b['bound_ms']:.4f} ms by "
            f"{b['bound_by']} ({b['bytes']} B -> {b['bytes_ms']:.4f} ms at "
            f"3.35 TB/s; {b['ops']} int32 ops -> {b['ops_ms']:.4f} ms); "
            f"kernel at {100 * b['bound_ms'] / ms:.2f}% of its bound; "
            f"{b['bytes'] / (ms * 1e-3) / 1e9:.1f} GB/s achieved; a device "
            f"copy of the same bytes takes {copy_ms:.4f} ms; no single "
            f"PyTorch call computes this integer fDCT + quantizer "
            f"(library_ms null)")
        timed[k] = {"blocks": n, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b["bound_ms"], "bound_by": b["bound_by"]}
    return {
        "name": "fdct_quant", "route": "cuda",
        "source": "theora_tpu_torch/csrc/fdct_quant.cu",
        "replaces": "theora_tpu/ops/pallas_kernels.py:194",
        "launches": None, "max_abs_err": err, "ms": timed[3]["ms"],
        "plain_ms": timed[3]["plain_ms"], "bound_ms": timed[3]["bound_ms"],
        "bound_by": timed[3]["bound_by"], "library_ms": None,
        "timed_blocks": n, "timed_rows": 3, "one_row": timed[1],
    }


def _kt_row_cases(device):
    """(label, KT arguments) at three qi rows, as adaptive quantization
    launches KT: K2's outputs on random residuals at the q56 inter triple
    (DC at the base qi) at 14,400, 3,600 and 21,600 blocks; per size an
    inter frame (inter flags at random, the inter lambdas of the three
    rows) with per-block lambda scales drawn in [0.1, 8], and an intra
    frame (the intra lambdas) without them."""
    from theora_tpu_torch.encode import aq
    from theora_tpu_torch.ops import fdct_cuda
    from theora_tpu_torch.tools import bench_fdct as bf
    from theora_tpu_torch.tools import bench_trellis as bt

    _, nb, lam_tab = bt.kt_tables()
    nb = torch.from_numpy(nb).to(device)
    qis = aq.qi_triple("auto", 56, 1, 0)
    rng = np.random.default_rng(20261021)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    for n, pli in ((14400, 0), (3600, 1), (21600, 2)):
        deq = t(bf.triple_rows(qis, pli))
        for qti in (1, 0):
            inter = (np.zeros(n, np.uint8) if qti == 0
                     else rng.integers(0, 2, n).astype(np.uint8))
            q, d = fdct_cuda.fdct_quantize(
                t(bf.random_residuals(rng, n)), deq, t(inter))
            sc = (t(rng.uniform(0.1, 8.0, n).astype(np.float32)) if qti
                  else None)
            yield (f"K2 outputs, 3 x {n} blocks, qis {qis}, "
                   f"{('intra', 'inter')[qti]} frame"
                   + (", lambda scales in [0.1, 8]" if qti else ""),
                   (q, d, deq, t(inter), t(lam_tab[qti, qis]), nb, sc))


def _kt_cases(device):
    """(label, KT arguments, timed) for one launch each: K2's outputs at
    three qi rows (_kt_row_cases); K2's outputs on random residuals at one
    qi row at the encode path's per-plane shapes, an intra and an inter
    frame each (tools/bench_trellis.py:k2_cases); the 720p clip's first
    frame, luma and chroma; the edge classes; a launch of blocks with no
    nonzero AC value; coefficients up to +-32767; the prefix-sum order
    cases, one launch per (qi, frame type)."""
    from theora_tpu_torch.ops import fdct_cuda, transforms
    from theora_tpu_torch.tools import bench_trellis as bt

    for label, args in _kt_row_cases(device):
        yield label, args, args[0].shape[1] == 14400 and "inter" in label
    for label, args in bt.k2_cases(device):
        yield label, args, args[0].shape[1] in (14400, 3600) and \
            "inter" in label
    for label, args in bt.first_frame_cases(device):
        yield label, args, True
    dq, nb, lam_tab = bt.kt_tables()
    nb = torch.from_numpy(nb).to(device)
    rng = np.random.default_rng(20261019)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def launch(dct, qi, qti, inter=None):
        """KT arguments for [N, 64] DCT rows of one frame type at qi; the
        round-to-nearest values from the plain quantizer, as K2 makes
        them."""
        n = len(dct)
        if inter is None:
            inter = np.full(n, qti, np.uint8)
        deq = dq[qi, 0].astype(np.int16)
        q = transforms.quantize(
            t(dct.astype(np.int32)),
            t(deq.astype(np.int32)[inter.astype(np.int64)]))
        return (q.to(torch.int16)[None], t(dct.astype(np.int16)),
                t(deq[None]), t(inter), t(lam_tab[qti, qi:qi + 1]), nb, None)

    # Edge classes among K2's outputs, a frame of each type at one qi: no
    # nonzero AC value (a fixed result), one nonzero value at position 63
    # (its combos wrap to position 0) or at position 1 (the first step's
    # headroom), dense +-32767.
    qi, n = 36, 2000
    rows = dq[qi, 0].astype(np.int32)
    for qti in (0, 1):
        inter = (np.zeros(n, np.uint8) if qti == 0
                 else rng.integers(0, 2, n).astype(np.uint8))
        res = rng.integers(-255, 256, (n, 64)) // rng.integers(1, 40, (n, 1))
        _, d = fdct_cuda.fdct_quantize(t(res.astype(np.int16)),
                                       t(rows[None].astype(np.int16)),
                                       t(inter))
        dct = d.cpu().numpy().astype(np.int32)
        r = rows[inter.astype(np.int64)]
        sign = rng.choice([-1, 1], (n, 64))
        k = np.arange(0, 400, 4)
        dct[k, 1:] = sign[k, 1:] * (r[k, 1:] // 2 - 1)
        dct[k + 1, 1:] = 0
        dct[k + 1, 63] = sign[k + 1, 63] * r[k + 1, 63] * (k % 37 + 1)
        dct[k + 2, 1:] = 0
        dct[k + 2, 1] = sign[k + 2, 1] * r[k + 2, 1] * (k % 37 + 1)
        dct[k + 3] = sign[k + 3] * 32767
        yield (f"edge classes among K2 outputs, {n} blocks, qi {qi}, "
               f"{('intra', 'inter')[qti]} frame",
               launch(dct, qi, qti, inter), False)
    # A whole launch without a nonzero AC value: every block skips the DP.
    dct = rng.integers(-255, 256, (3600, 64))
    dct[:, 1:] //= 64
    yield ("3600 blocks without a nonzero AC value, q48",
           launch(dct, 48, 0), True)
    for qi in (5, 30, 60):
        for qti in (0, 1):
            yield (f"coefficients up to +-32767, 250 blocks, qi {qi}, "
                   f"{('intra', 'inter')[qti]}",
                   launch(rng.integers(-32767, 32768, (250, 64)), qi, qti),
                   False)
    cases = np.load(os.path.join(TESTDATA, "vectors",
                                 "trellis_order_cases.npz"))
    for qi, qti in sorted(set(zip(cases["qi"].tolist(),
                                  cases["qti"].tolist()))):
        sel = (cases["qi"] == qi) & (cases["qti"] == qti)
        yield (f"trellis_order_cases.npz, qi {qi}, qti {qti}, "
               f"{int(sel.sum())} blocks",
               launch(cases["dct"][sel], qi, qti), False)
    # Fractional lambdas, where the placement of the fused multiply-adds
    # decides: lambda 1 times each block's own scale.
    cases = np.load(os.path.join(TESTDATA, "vectors",
                                 "trellis_fma_cases.npz"))
    for qi, qti in sorted(set(zip(cases["qi"].tolist(),
                                  cases["qti"].tolist()))):
        sel = (cases["qi"] == qi) & (cases["qti"] == qti)
        args = list(launch(cases["dct"][sel], qi, qti))
        args[4] = t(np.ones(1, np.float32))
        args[6] = t(cases["lam"][sel])
        yield (f"trellis_fma_cases.npz, qi {qi}, qti {qti}, "
               f"{int(sel.sum())} blocks", tuple(args), False)


def kt_vs_plain(device) -> dict:
    from theora_tpu_torch.ops import transforms, trellis_cuda
    from theora_tpu_torch.tools import bench_trellis as bt

    err = 0
    n_order = n_launches = 0
    timed = []
    for label, args, is_timed in _kt_cases(device):
        got = trellis_cuda.trellis_quantize(*args)
        want = transforms.trellis_quantize(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            err = max(err, int((g.int() - w.int()).abs().max()))
            if not torch.equal(g, w):
                bad = int((g != w).reshape(len(g), -1).any(dim=1).sum())
                raise AssertionError(f"KT != plain on {label}: {bad} blocks "
                                     f"differ (max |d| {err})")
        n_launches += 1
        nblk = want[0].numel() // 64
        if label.startswith(("trellis_order_cases", "trellis_fma_cases")):
            n_order += nblk
            continue
        moved = int((want[0] != args[0]).any(dim=2).sum())
        log(f"[kt] {label}: kernel == plain (values, counts, DC-only flags); "
            f"the trellis changed {moved} of {nblk} (row, block) pairs' "
            f"round-to-nearest values; {int(want[2].sum())} DC-only")
        if is_timed:
            timed.append((label, args))
    log(f"[kt] trellis_order_cases.npz and trellis_fma_cases.npz: "
        f"{n_order} blocks, kernel == plain in every (qi, frame type) "
        f"launch; {n_launches} launches in all; max |err| {err} "
        f"(tolerance 0: exact)")

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    for i, (label, args) in enumerate(timed):
        ms = bt.event_ms(lambda: trellis_cuda.trellis_quantize(*args), 50,
                         flush)
        b = bt.kt_bound(args)
        hist = bt.nonzero_histogram(args[0].reshape(-1, 64).cpu().numpy())
        log(f"[kt] time, {label}: kernel {ms:.4f} ms; bound "
            f"{b['bound_ms']:.4f} ms by {b['bound_by']} ({b['bytes']} B -> "
            f"{b['bytes_ms']:.4f} ms at 3.35 TB/s; {b['ops']} float32 ops "
            f"that these inputs need -> {b['ops_ms']:.4f} ms at 67 TFLOP/s);"
            f" kernel at {100 * b['bound_ms'] / ms:.2f}% of its bound; "
            f"blocks by nonzero AC values {hist}")
        if i == 0:  # 3 x 14,400 (row, block) pairs: one 720p luma plane
            head, head_ms, head_bound = label, ms, b
            plain_ms = bt.event_ms(
                lambda: transforms.trellis_quantize(*args), 5, flush)
        elif i == 1:  # the same plane at one qi row
            one_row = {"blocks": int(args[0].shape[1]), "ms": ms,
                       "bound_ms": b["bound_ms"], "bound_by": b["bound_by"]}
    log(f"[kt] {head}: plain {plain_ms:.4f} ms; no single PyTorch call "
        f"computes this trellis (library_ms null)")
    return {
        "name": "trellis", "route": "cuda",
        "source": "theora_tpu_torch/csrc/trellis.cu",
        "replaces": "theora_tpu/ops/transforms_jax.py:300",
        "launches": None, "max_abs_err": err, "ms": head_ms,
        "plain_ms": plain_ms, "bound_ms": head_bound["bound_ms"],
        "bound_by": head_bound["bound_by"], "library_ms": None,
        "timed_blocks": 14400, "timed_rows": 3, "one_row": one_row,
    }


def kr_vs_plain(device) -> dict:
    """6c: KR's two entries on the card, exact equality of the values,
    nonzero counts and DC-only flags. The standalone entry
    (qrd_cuda.quantize_rd, the test hook) against its plain version on
    K2's outputs, the edge classes and the FMA near-ties, which only DCT
    values reach; the fused entry (qrd_cuda.fdct_quantize_rd, the encode
    scan's) against its plain version and the K2 -> KR chain on random
    residuals and over 3 mesh segments. Times (tools/bench_qrd.py): the
    fused entry beside the chain and K2 alone in turns, and the standalone
    entry beside KT."""
    from theora_tpu_torch.ops import qrd_cuda, transforms
    from theora_tpu_torch.tools import bench_qrd as bq
    from theora_tpu_torch.tools import bench_segments as bs

    err = 0

    def check(label, args):
        nonlocal err
        got = qrd_cuda.quantize_rd(*args)
        want = transforms.quantize_rd_rows(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            err = max(err, int((g.int() - w.int()).abs().max()))
            if not torch.equal(g, w):
                bad = int((g != w).reshape(len(g), -1).any(dim=1).sum())
                raise AssertionError(f"KR != plain on {label}: {bad} rows "
                                     f"differ (max |d| {err})")
        return want

    for label, args in bq.kr_cases(device):
        want = check(label, args)
        moved = int((want[0] != args[0]).any(dim=2).sum())
        log(f"[kr] standalone entry, {label}: kernel == plain (values, "
            f"counts, DC-only flags); {moved} of {want[0].numel() // 64} "
            f"(row, block) pairs moved off round-to-nearest; "
            f"{int(want[2].sum())} DC-only")
    want = check("edge classes", bq.edge_args(device))
    log(f"[kr] standalone entry, edge classes (lone +-1 at positions 1 and "
        f"63, +-1 pairs, no nonzero AC value, +-32767), "
        f"{want[0].shape[1]} blocks: kernel == plain")
    path = os.path.join(TESTDATA, "vectors", "qrd_fma_cases.npz")
    n = 0
    for n, args in enumerate(bq.fma_args(path, device), 1):
        check(f"qrd_fma_cases.npz block {n - 1}", args)
    log(f"[kr] standalone entry, qrd_fma_cases.npz: {n} blocks, one launch "
        f"each, kernel == plain; max |err| {err} (tolerance 0: exact)")

    # The fused entry: K2's block core and the same row step in one launch.
    # 3,600 blocks end in a partial CTA.
    for label, args in bq.kr_cases(device, fused=True):
        got = bq.check_fused(args)
        torch.cuda.synchronize()
        log(f"[kr] fused entry, {label}: kernel == plain == K2 -> KR chain "
            f"(values, counts, DC-only flags); {int(got[2].sum())} DC-only")
    c = bs.segment_case(np.random.default_rng(bs.SEED + 1), 14400, 3, device)
    for k in (1, 2, 3):
        bq.check_fused((c["res"], c["deq"][:, :k].contiguous(), c["inter"],
                        c["lam_q"][:, :k].contiguous()))
    torch.cuda.synchronize()
    log(f"[kr] fused entry, 3 mesh segments x 14400 blocks at K = 1, 2, 3 "
        f"(qi triples {c['qis']}, lambdas per segment): kernel == plain == "
        f"3-segment chain; tolerance 0: exact")

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    fused = {}
    for label, args in bq.fused_shapes(device):
        r = bq.time_fused(args, flush)

        def ms(key):
            return " / ".join(f"{x:.4f}" for x in r[key])

        log(f"[kr] time, fused entry, {label}: fused {ms('fused_ms')} ms, "
            f"K2 -> KR chain {ms('chain_ms')} ms, K2 alone {ms('k2_ms')} ms "
            f"(in turns: chain, fused, K2, K2, fused, chain), plain "
            f"{r['plain_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']} ({r['bytes']} B -> {r['bytes_ms']:.4f} ms at "
            f"3.35 TB/s; {r['int32_ops']} int32 + {r['float32_ops']} "
            f"float32 ops -> {r['ops_ms']:.4f} ms); fused at "
            f"{100 * r['bound_ms'] / min(r['fused_ms']):.2f}% of its bound; "
            f"no single PyTorch call computes this (library_ms null)")
        fused[label] = r
    rng = np.random.default_rng(20261023)
    alone = {}
    for k in (1, 3):
        qis = bq.qi_lists()[k]
        r = bq.time_case(bq.kr_args(rng, 14400, qis, 0, device), qis, flush)
        log(f"[kr] time, standalone entry at K = {k}, 14400 blocks: kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms; bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']} ({r['bytes']} B); a "
            f"device copy of the same bytes takes {r['copy_ms']:.4f} ms; KT "
            f"on the same K2 outputs {r['kt_ms']:.4f} ms")
        alone[k] = {key: r[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "kt_ms")}
    one = fused["14400 blocks, K = 1"]

    def mean(v):
        return sum(v) / len(v)

    return {
        "name": "quantize_rd", "route": "cuda",
        "source": "theora_tpu_torch/csrc/quantize_rd.cu",
        "replaces": "theora_tpu/ops/transforms_jax.py:185",
        "launches": None, "max_abs_err": err, "ms": mean(one["fused_ms"]),
        "plain_ms": one["plain_ms"], "bound_ms": one["bound_ms"],
        "bound_by": one["bound_by"], "library_ms": None,
        "timed_entry": "fdct_quantize_rd", "timed_blocks": 14400,
        "timed_rows": 1, "chain_ms": mean(one["chain_ms"]),
        "k2_ms": mean(one["k2_ms"]),
        "fused_shapes": {label: {key: r[key] for key in (
            "fused_ms", "chain_ms", "k2_ms", "plain_ms", "bound_ms",
            "bound_by")} for label, r in fused.items()},
        "standalone_entry": {f"{k} rows": v for k, v in alone.items()},
    }


def km_vs_plain(device) -> dict:
    """6d: KM (the ME plan, ops/me_cuda.py) against its plain version
    (ops/me.py:plan_with_gold) on the card, all 11 outputs exactly equal,
    on tools/bench_me.py:cases (the 720p encode chunk and mesh batch, the
    synthetic frames that tie, saturate the search, reach the byte
    extremes and every word alignment, at 720p, 176x144 and 64x48); the
    byte SIMD issue rates (bench_me.simd_rates); CUDA-event times at 7
    and 23 rows, each launch alone too, beside the bound
    (bench_me.km_bound), the bound at the measured rates and the plain
    version."""
    from theora_tpu_torch.ops import me, me_cuda
    from theora_tpu_torch.tools import bench_me as bm

    hd = bm.hd720_luma(24)
    err = 0
    for label, ys, gold in bm.cases(device, hd):
        got = me_cuda.plan_with_gold(ys, gold)
        want = me.plan_with_gold(ys, gold)
        torch.cuda.synchronize()
        ok, e = bm.same(got, want)
        err = max(err, e)
        if not ok:
            bad = [i for i, (g, w) in enumerate(zip(got, want))
                   if not torch.equal(g, w)]
            raise AssertionError(f"KM != plain on {label}: outputs {bad} "
                                 f"differ (max |d| {e})")
        sat = int((want[0].abs() == 31).any(dim=-1).sum())
        log(f"[km] {label}: kernel == plain (all 11 outputs; {sat} MB "
            f"vectors at the +-15 limit; {int((want[5] != 0).any(-1).sum())}"
            f" nonzero candidates)")
    log(f"[km] max |err| {err} (tolerance 0: exact)")
    rates = bm.simd_rates(device)
    for op, r in rates.items():
        log(f"[km] issue rate of {op}: {r['per_sm_clock']:.2f} per SM per "
            f"clock, {r['per_s'] / 1e12:.3f} T/s (bench_me.simd_rates)")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    timed = {}
    for nf in (bm.KF, 24):
        ys = torch.from_numpy(hd[:nf]).to(device)
        gold = torch.from_numpy(bm.gop_gold(nf)).to(device)
        r = bm.time_case(ys, gold, flush)
        r["stages_ms"] = bm.stage_ms(me_cuda._load(), ys, gold, flush)
        at = bm.km_bound_at(ys, rates)
        r["bound_at_measured_rates_ms"] = at["bound_ms"]
        log(f"[km] time at 720p, {r['rows']} rows: kernel {r['ms']:.4f} ms "
            f"(3 launches: " + ", ".join(
                f"{k} {v:.4f}" for k, v in r["stages_ms"].items())
            + f" ms alone), plain {r['plain_ms']:.4f} ms; bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']} ({r['ops']} ops, "
            f"byte SIMD counted as bench_me.km_ops -> {r['ops_ms']:.4f} ms "
            f"at 33.5 T/s; {r['bytes']} B -> {r['bytes_ms']:.4f} ms at 3.35 "
            f"TB/s), {at['bound_ms']:.4f} ms at the measured issue rates "
            f"(bench_me.km_bound_at); kernel at "
            f"{100 * r['bound_ms'] / r['ms']:.2f}% / "
            f"{100 * at['bound_ms'] / r['ms']:.2f}% of them; no single "
            f"PyTorch call computes the plan (library_ms null)")
        timed[nf] = r
    one = timed[bm.KF]
    return {
        "name": "me_plan", "route": "cuda",
        "source": "theora_tpu_torch/csrc/me.cu",
        "replaces": "theora_tpu/ops/me_jax.py:527",
        "launches": None, "max_abs_err": err, "ms": one["ms"],
        "plain_ms": one["plain_ms"], "bound_ms": one["bound_ms"],
        "bound_by": one["bound_by"], "library_ms": None,
        "timed_rows": one["rows"], "stages_ms": one["stages_ms"],
        "bound_at_measured_rates_ms": one["bound_at_measured_rates_ms"],
        "simd_rates_per_sm_clock": {
            op: r["per_sm_clock"] for op, r in rates.items()},
        "mesh_batch": {key: timed[24][key] for key in (
            "rows", "ms", "plain_ms", "bound_ms", "bound_by", "stages_ms",
            "bound_at_measured_rates_ms")},
    }


def kl_vs_plain(device) -> dict:
    """6e: KL (the loop filter and the borders, ops/loopfilter_cuda.py)
    against its plain version (ops/loopfilter.py:loop_filter_plane, then
    ops/loopfilter.py:fill_borders) on the card, byte for byte over the
    whole padded plane, on tools/bench_loopfilter.py:cases (the 720p
    planes, 4:2:2 and 4:4:4 chroma, one row, one column, limits 1-63, the
    densities and the built corner patterns, the same at the kernel's
    tile seams, 0/255 pixels, three planes in one launch with limits [5,
    0, 31]; bench_loopfilter.check), one launch per call, the input left
    as it was; CUDA-event times at the 720p luma and chroma planes and a
    frame's three planes beside the bound (bench_loopfilter.kl_bound), the
    plain version, a device copy of the same bytes and one launch's floor
    (an empty kernel), and in turns with the earlier design
    (tools/kl_row_ctas.cu, one CTA per fragment row) alone and followed
    by fill_borders, the work KL replaces."""
    from theora_tpu_torch.tools import bench_loopfilter as bl

    parent = bl.parent_kernel()
    for line in bl.ptxas(parent.so):
        log(f"[kl] ptxas, the earlier design: {line}")
    n, err = bl.check(device)
    log(f"[kl] {n} cases: kernel == plain (filter, then borders) byte for "
        f"byte, one launch each, input untouched; max |err| {err} "
        f"(tolerance 0: exact)")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    rows = bl.timed_shapes(device, flush, parent)
    for label, r in rows.items():
        log(f"[kl] time, {bl.describe(label, r)}; no single PyTorch call "
            f"computes the filter (library_ms null)")
    one = rows["720p luma"]
    return {
        "name": "loop_filter", "route": "cuda",
        "source": "theora_tpu_torch/csrc/loopfilter.cu",
        "replaces": "theora_tpu/ops/loopfilter_jax.py:71",
        "launches": None, "max_abs_err": err, "ms": one["ms"],
        "plain_ms": one["plain_ms"], "bound_ms": one["bound_ms"],
        "bound_by": one["bound_by"], "library_ms": None,
        "timed": "720p luma plane, one launch (filter and borders)",
        "copy_ms": one["copy_ms"], "floor_ms": one["floor_ms"],
        "shapes": {label: {k: r[k] for k in (
            "ms", "ms_runs", "parent_ms", "chain_ms", "plain_ms", "copy_ms",
            "floor_ms", "bound_ms", "bound_by")}
            for label, r in rows.items()},
    }


def _encoder(w, h, fmt, qi, adaptive_quant, quality=None, splevel=0):
    from theora_tpu_torch.encode.gop import GopEncoder
    from theora_tpu_torch.info import TheoraInfo

    enc = GopEncoder(TheoraInfo(frame_width=w, frame_height=h,
                                pic_width=w, pic_height=h,
                                quality=qi if quality is None else quality,
                                pixel_fmt=fmt), qi=qi, device="cuda",
                     adaptive_quant=adaptive_quant)
    enc.set_splevel(splevel)
    return enc


def _packet_hashes(pkts) -> list[str]:
    return [hashlib.sha256(p.data).hexdigest() for p in pkts]


def _check_hashes(pkts, name: str, what: str, blob=None) -> int:
    """Packets (and a 2-pass encode's metrics blob, the list's last line)
    against the JAX encoder's list."""
    got = _packet_hashes(pkts)
    if blob is not None:
        got.append(hashlib.sha256(blob).hexdigest())
    return _check_listed(got, name, what)


def _check_listed(got: list[str], name: str, what: str) -> int:
    """SHA-256 hex digests against the list `name`."""
    with open(os.path.join(TESTDATA, f"{name}.sha256")) as f:
        want = f.read().split()
    bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    if len(got) != len(want) or bad:
        raise AssertionError(f"{name} {what}: packets {bad} differ from the "
                             f"JAX encoder's")
    return len(want)


def _frame_qis(pkts) -> list[int]:
    """The base qi in each data packet's frame header."""
    return [p.data[0] & 0x3F for p in pkts[3:]]


def _closed_loop(enc, frames, what: str, frame_qi=None, want=None) -> None:
    """One GOP's carried reconstruction (at per-frame qis frame_qi, if
    given) against the port's decoder on its packets, which must equal
    want where given."""
    from theora_tpu_torch.decode.batch import BatchDecoder
    from theora_tpu_torch.headers import parse_info_header, \
        parse_setup_header

    datas, recon = enc.finish_gop(enc.dispatch_gop(frames, want_recon=True,
                                                   frame_qi=frame_qi))
    if want is not None and datas != want:
        raise AssertionError(f"{what}: the GOP's packets differ from the "
                             f"clip's")
    hdr = enc.flush_headers()
    outs = BatchDecoder(parse_info_header(hdr[0].data),
                        parse_setup_header(hdr[2].data),
                        device="cuda").decode_clip(datas, batch=8)
    g = enc.g
    for f, out in enumerate(outs):
        for pli in range(3):
            vpad, hpad = g.plane_padding(pli)
            h, w = g.plane_shape(pli)
            if not np.array_equal(
                    recon[pli][f][vpad:vpad + h, hpad:hpad + w][::-1],
                    out[pli]):
                raise AssertionError(f"{what} closed loop: frame {f} plane "
                                     f"{pli} recon != decode")
    log(f"[{what}] closed loop: the GOP's {len(outs)} reconstructed frames "
        f"equal BatchDecoder(device='cuda') on its packets")


def small_encodes() -> None:
    """64x48 in three pixel formats (adaptive_quant=False, as their list
    was made); the 96x64 half-smooth, half-noise clip (adaptive_quant=True:
    the triple, noise-like frames) and the half-smooth, half-texture clip
    ("auto": the triple with per-block lambda scales), each with its
    closed loop."""
    mk = _load_testdata("make_hd720_enc")
    got = []
    for fmt in mk.SMALL_FORMATS:
        frames = mk.moving_frames(64, 48, fmt, mk.SMALL_FRAMES, 11 + fmt)
        got += _encoder(64, 48, fmt, mk.SMALL_QI, False).encode_clip(
            frames, keyframe_freq=mk.SMALL_KF, clip_batch=8)
    n = _check_hashes(got, "enc64x48", "formats 0, 2, 3")
    log(f"[enc64x48] formats {mk.SMALL_FORMATS}: all {n} packets equal the "
        f"JAX TpuGopEncoder's (SHA-256)")
    for name, frames, qi, mode in (
            ("mixed96x64_q40_aq_enc", mk.mixed_frames(), mk.MIXED_QI, True),
            ("halftex96x64_q48_aq_enc", mk.halftexture_frames(),
             mk.HALFTEX_QI, "auto")):
        enc = _encoder(mk.MIXED_W, mk.MIXED_H, 0, qi, mode)
        n = _check_hashes(enc.encode_clip(
            frames, keyframe_freq=mk.MIXED_FRAMES, clip_batch=8), name,
            f"adaptive_quant={mode}")
        if enc.nonbase_qi_blocks == 0:
            raise AssertionError(f"{name}: no block took a non-base qi")
        log(f"[{name}] adaptive_quant={mode}: all {n} packets equal the JAX "
            f"encoder's; {enc.nonbase_qi_blocks} coded blocks at a non-base "
            f"qi")
        _closed_loop(_encoder(mk.MIXED_W, mk.MIXED_H, 0, qi, mode), frames,
                     name)
    got = []
    for lvl in (2, 4):
        got += _encoder(64, 48, 0, mk.SMALL_QI, "auto", splevel=lvl
                        ).encode_clip(mk.moving_frames(64, 48, 0,
                                                       mk.SMALL_FRAMES, 11),
                                      keyframe_freq=mk.SMALL_KF)
    n = _check_hashes(got, "enc64x48_sp24", "speed levels 2 and 4")
    log(f"[enc64x48_sp24] speed levels 2 and 4: all {n} packets equal the "
        f"JAX encoder's")
    for name, frames, qi, mode in (
            ("mixed96x64_q40_aq_rd_enc", mk.mixed_frames(), mk.MIXED_QI,
             True),
            ("halftex96x64_q48_aq_rd_enc", mk.halftexture_frames(),
             mk.HALFTEX_QI, "auto")):
        enc = _encoder(mk.MIXED_W, mk.MIXED_H, 0, qi, mode)
        enc.use_trellis = False
        n = _check_hashes(enc.encode_clip(
            frames, keyframe_freq=mk.MIXED_FRAMES), name,
            f"use_trellis=False, adaptive_quant={mode}")
        if enc.nonbase_qi_blocks == 0:
            raise AssertionError(f"{name}: no block took a non-base qi")
        log(f"[{name}] use_trellis=False (KR at three qi rows), "
            f"adaptive_quant={mode}: all {n} packets equal the JAX "
            f"encoder's; {enc.nonbase_qi_blocks} coded blocks at a non-base "
            f"qi")
    pkts = _encoder(64, 48, 0, mk.SMALL_QI, "auto").encode_clip(
        mk.cut_frames(), keyframe_freq=mk.CUT_KF, auto_keyframe=True)
    n = _check_hashes(pkts, "cut64x48_autokf_enc", "auto_keyframe")
    log(f"[cut64x48_autokf_enc] auto_keyframe: all {n} packets equal the JAX "
        f"encoder's")
    enc = _encoder(64, 48, 0, mk.CBR_QI, "auto")
    pkts = enc.encode_clip(mk.cbr_frames(), keyframe_freq=mk.CBR_KF,
                           target_bitrate=mk.CBR_RATE, rate_window=1)
    n = _check_hashes(pkts, "cbr64x48_enc", "CBR")
    if enc.qi == mk.CBR_QI:
        raise AssertionError("cbr64x48_enc: the qi never moved")
    log(f"[cbr64x48_enc] CBR at {mk.CBR_RATE} bit/s: all {n} packets equal "
        f"the JAX encoder's; frame qis {_frame_qis(pkts)}")
    pkts, blob = _encoder(64, 48, 0, mk.CBR_QI, "auto", quality=0
                          ).encode_clip_twopass(
        mk.cbr_frames(), keyframe_freq=mk.CBR_KF, target_bitrate=mk.CBR_RATE)
    n = _check_hashes(pkts, "twopass64x48_enc", "2-pass", blob)
    log(f"[twopass64x48_enc] 2-pass at {mk.CBR_RATE} bit/s: all {n} lines "
        f"(packets and the pass-1 metrics blob) equal the JAX encoder's; "
        f"frame qis {_frame_qis(pkts)}")


def mesh_filter_small() -> int:
    """7 (end): encode_clip_mesh of the scene-cut clip under CBR at gop
    axis 4 on the card (the 8-, 1- and 5-frame GOPs in one batch, qi 40
    and below): every packet against mesh64x48_cut_cbr_enc, JAX's mesh's
    list; KL, counted from 0, must run once per plane per frame step over
    a stack of more than one plane with a limit above 0. Returns KL's
    launches."""
    from theora_tpu_torch.info import TheoraInfo
    from theora_tpu_torch.ops import loopfilter_cuda
    from theora_tpu_torch.parallel.gop import encode_clip_mesh, make_mesh

    mk = _load_testdata("make_hd720_enc")
    info = TheoraInfo(frame_width=64, frame_height=48, pic_width=64,
                      pic_height=48, quality=mk.SMALL_QI)
    real = loopfilter_cuda.loop_filter_plane
    stacks = []

    def spy(plane, coded, limit, *rest):
        out = real(plane, coded, limit, *rest)
        stacks.append((plane.shape[0] if plane.dim() == 3 else 1,
                       int(limit.max()) if plane.dim() == 3 else limit))
        return out

    spy.launches = 0  # the wrapper counts on the name it is bound to
    _reset_counts()
    loopfilter_cuda.loop_filter_plane = spy
    try:
        pkts = encode_clip_mesh(
            mk.cut_frames(), info, make_mesh(4), keyframe_freq=mk.CUT_KF,
            qi=mk.SMALL_QI, target_bitrate=mk.MESH_CBR_RATE, rate_window=3,
            auto_keyframe=True)
    finally:
        loopfilter_cuda.loop_filter_plane = real
    n = _check_hashes(pkts, "mesh64x48_cut_cbr_enc", "mesh, gop axis 4")
    kl = spy.launches
    if kl != len(stacks) or not any(g > 1 and lim > 0 for g, lim in stacks):
        raise AssertionError(f"mesh 64x48 CBR: KL launches {kl} over "
                             f"(planes, largest limit) {stacks}")
    log(f"[mesh64x48_cut_cbr_enc] gop axis 4, CBR: all {n} packets equal "
        f"JAX's mesh's; KL launches {kl}, (planes, largest limit) of each "
        f"{sorted(set(stacks))}")
    return kl


def _psnr(frames, outs) -> float:
    se = n = 0
    for src, dec in zip(frames, outs):
        for a, b in zip(src, dec):
            d = a.astype(np.int64) - b.astype(np.int64)
            se += int((d * d).sum())
            n += d.size
    return 10 * np.log10(255.0 ** 2 * n / max(se, 1))


def ks_vs_plain(device) -> dict:
    """6f: KS (MC, the skip test and the plane's assembly with its
    borders, ops/mc_cuda.py) against its plain versions (ops/mc.py) on the
    card, every output byte for byte with the planes' padding, one launch
    per call and the inputs untouched, on tools/bench_mc.py:cases and the
    split form (bench_mc.check); KS fused into K2's, KR's and K1's encode
    entries against their plain and kernel chains (bench_mc.check_fused);
    CUDA-event times of each entry at the 720p luma and 4:2:0 chroma
    shapes beside the bound (bench_mc.ks_bound), the plain chain, a device
    copy moving the same bytes and an empty kernel's launch
    (bench_mc.timed_entries), and of the fused entries in turns with the
    chains they replaced (bench_mc.timed_fused). The kernel line's times
    are KS's one launch of its own on the main path, mc_recon on a 720p
    luma decode step; "fused" holds the encode step's entries."""
    from theora_tpu_torch.ops import fdct_cuda, idct_cuda, mc_cuda, \
        qrd_cuda
    from theora_tpu_torch.tools import bench_mc as bm

    for so in (mc_cuda._SO, fdct_cuda._SO, qrd_cuda._SO, idct_cuda._SO):
        for line in bm.ptxas(so):
            log(f"[ks] ptxas {os.path.basename(so)}: {line}")
    n, err = bm.check(device)
    log(f"[ks] {n} calls of mc_residual, skip_place, skip_rows, place_rows "
        f"and mc_recon: kernel == plain byte for byte (every output, the "
        f"planes' padding), one launch each, inputs untouched; max |err| "
        f"{err} (tolerance 0: exact)")
    nf, errf = bm.check_fused(device)
    log(f"[ks] {nf} fused cases: mc_fdct_quantize, mc_fdct_quantize_rd and "
        f"mc_idct_recon_skip == their plain and kernel chains byte for byte "
        f"(the plane and its padding or the rows, qout, coded, qii), one "
        f"launch each, inputs untouched; the engineered blocks skip at "
        f"lambda 8 and one ulp above, are coded one ulp below; max |err| "
        f"{errf} (tolerance 0: exact)")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    rows = bm.timed_entries(device, flush)
    for label, r in rows.items():
        log(f"[ks] time, {bm.describe(label, r)}; no single PyTorch call "
            f"computes it (library_ms null)")
    fused = bm.timed_fused(device, flush)
    for label, r in fused.items():
        log(f"[ks] time, {bm.describe_fused(label, r)}; no single PyTorch "
            f"call computes it (library_ms null)")
    dec = rows[f"mc_recon, {bm.HD_PLANES[0][0]} (14400 blocks)"]
    return {
        "name": "mc_skip_place", "route": "cuda",
        "source": "theora_tpu_torch/csrc/mc.cu",
        "also_sources": ["theora_tpu_torch/csrc/mc_core.cuh"],
        "replaces": "theora_tpu/encode/tpu_gop.py:182",
        "also_replaces": ["theora_tpu/encode/tpu_gop.py:286",
                          "theora_tpu/decode/tpu_batch.py:114"],
        "launches": None, "max_abs_err": max(err, errf),
        "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": None,
        "timed": "720p luma plane, one decode frame step: mc_recon, KS's "
                 "one launch of its own on the main path; on an encode "
                 "step KS runs inside K2's, KR's and K1's fused entries "
                 "(fused)",
        "entries": {label: {k: r[k] for k in (
            "ms", "ms_runs", "plain_ms", "copy_ms", "floor_ms", "bound_ms",
            "bound_by", "bytes")} for label, r in rows.items()},
        "fused": {label: {k: r[k] for k in (
            "ms", "ms_runs", "chain_ms", "chain_ms_runs", "plain_ms",
            "floor_ms", "bound_ms", "bound_by", "bytes")}
            for label, r in fused.items()},
    }


def _reset_counts() -> None:
    from theora_tpu_torch.ops import fdct_cuda, idct_cuda, loopfilter_cuda, \
        mc_cuda, me_cuda, postproc_cuda, qrd_cuda, trellis_cuda

    torch.cuda.synchronize()
    for w in (idct_cuda.dequantize_idct_frames, idct_cuda.idct_recon_choose,
              idct_cuda.mc_idct_recon_skip, fdct_cuda.fdct_quantize,
              fdct_cuda.mc_fdct_quantize, trellis_cuda.trellis_quantize,
              qrd_cuda.fdct_quantize_rd, qrd_cuda.mc_fdct_quantize_rd,
              qrd_cuda.quantize_rd, me_cuda.plan_with_gold,
              loopfilter_cuda.loop_filter_plane, *mc_cuda.ENTRIES,
              postproc_cuda.postprocess_plane,
              postproc_cuda.postprocess_frames):
        w.launches = 0


def _ks_counts() -> dict:
    """KS's launches since _reset_counts, by entry."""
    from theora_tpu_torch.ops import mc_cuda

    return {w.__name__: w.launches for w in mc_cuda.ENTRIES}


def _ks_encode(what: str) -> int:
    """KS on an encode path without a frag group since _reset_counts: no
    launch of its own (its MC, skip test and plane assembly run inside
    K2's or KR's and K1's fused entries), no decode entry. Returns 0."""
    c = _ks_counts()
    if any(c.values()):
        raise AssertionError(f"{what}: KS launches {c}; expected none (an "
                             f"encode step launches no KS kernel)")
    return 0


def _ks_decode_only(what: str, want: int) -> int:
    """KS's decode entry since _reset_counts: want launches (3 per decoded
    frame), no encode-side entry. Returns them."""
    c = _ks_counts()
    if c["mc_recon"] != want or any(v for k, v in c.items()
                                    if k != "mc_recon"):
        raise AssertionError(f"{what}: KS launches {c}; expected mc_recon "
                             f"{want} and nothing else")
    return want


# The fused entries' launches (K1's, K2's and KR's, KS's work inside them)
# per encode path, as _read_counts reads them.
KS_FUSED = {}


def _read_counts(what: str, want: tuple, kl: int = 0,
                 fused: bool = True) -> tuple:
    """(K1's encode entry, K2, KT, KR, KM, KL, KS) launches since
    _reset_counts; the first five must equal want and KL's kl (one per
    plane per frame step whose limit is above 0: none at q >= 47). With
    fused (the encode scan's paths), K1's, K2's and KR's entries are the
    fused ones (idct_cuda.mc_idct_recon_skip, fdct_cuda.mc_fdct_quantize,
    qrd_cuda.mc_fdct_quantize_rd), their standalone entries must not have
    run, and KS must have launched nothing of its own (_ks_encode);
    without (the batch intra encoder), the standalone entries and no fused
    one. Neither K1's decode entry nor KR's standalone entry may have run.
    KM launches three times per ME plan: one plan per chunk of
    encode_clip, per GOP of a 2-pass encode's pass 2, per mesh batch."""
    from theora_tpu_torch.ops import fdct_cuda, idct_cuda, loopfilter_cuda, \
        me_cuda, qrd_cuda, trellis_cuda

    entries = ((idct_cuda.mc_idct_recon_skip, idct_cuda.idct_recon_choose),
               (fdct_cuda.mc_fdct_quantize, fdct_cuda.fdct_quantize),
               (qrd_cuda.mc_fdct_quantize_rd, qrd_cuda.fdct_quantize_rd))
    used = [e[0] if fused else e[1] for e in entries]
    unused = {w.__name__: w.launches for e in entries
              for w in (e[1] if fused else e[0],) if w.launches}
    if unused:
        raise AssertionError(f"{what}: launches of {unused}; expected "
                             f"{'the fused' if fused else 'the standalone'}"
                             f" entries alone")
    counts = (used[0].launches, used[1].launches,
              trellis_cuda.trellis_quantize.launches, used[2].launches,
              me_cuda.plan_with_gold.launches,
              loopfilter_cuda.loop_filter_plane.launches)
    if counts != tuple(want) + (kl,):
        raise AssertionError(f"{what} launches: K1 (encode entry), K2, KT, "
                             f"KR, KM, KL {counts}; expected {want} and KL "
                             f"{kl}")
    if idct_cuda.dequantize_idct_frames.launches:
        raise AssertionError(f"{what}: the encode launched K1's decode "
                             f"entry")
    if qrd_cuda.quantize_rd.launches:
        raise AssertionError(f"{what}: the encode launched KR's standalone "
                             f"entry")
    if not fused:
        return counts + (_ks_decode_only(what, 0),)
    KS_FUSED[what] = counts[0] + counts[1] + counts[3]
    return counts + (_ks_encode(what),)


def real_size_encode(smi: str, name: str, qi: int, adaptive_quant,
                     splevel: int = 0):
    """16 frames of the 1280x720 clip, a keyframe every 8, clip_batch 8:
    packets against the JAX encoder's list `name`, the first GOP's closed
    loop, and a warm pass with the launch counts of K1 (both entries), K2,
    KT and KR (both entries) reset just before it: K1's encode entry and
    the quantizer (K2 and KT at speed levels 0-1, KR's fused entry alone
    at 2-4) must each run once per plane per frame, the other kernels, K1's
    decode entry and KR's standalone entry not at all. Returns the counts
    (K1 encode entry, K2, KT, KR, KM, KL, KS)."""
    from theora_tpu_torch.decode.batch import BatchDecoder
    from theora_tpu_torch.headers import parse_info_header, \
        parse_setup_header

    mk = _load_testdata("make_hd720_enc")
    frames = mk.hd_frames()
    what = f"enc720p q{qi} aq={adaptive_quant} sp{splevel}"

    def encode(enc):
        return enc.encode_clip(frames, keyframe_freq=mk.HD_KF, clip_batch=8)

    def make():
        return _encoder(1280, 720, 0, qi, adaptive_quant, splevel=splevel)

    _check_hashes(encode(make()), name, "first pass")
    _closed_loop(make(), frames[:mk.HD_KF], what)

    # Warm pass, the main path: launch counts from 0 just before it.
    enc = make()
    enc.device_spans = []
    _reset_counts()
    t0 = time.perf_counter()
    pkts = encode(enc)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    per = 3 * len(frames)
    counts = _read_counts(what, (per,) + ((per, per, 0) if splevel < 2
                                          else (0, 0, per))
                          + (3 * (len(frames) // mk.HD_KF),))
    n = _check_hashes(pkts, name, "warm pass")
    if adaptive_quant and splevel < 2 and enc.nonbase_qi_blocks == 0:
        raise AssertionError(f"{what}: no block took a non-base qi")
    dev_s = sum(a.elapsed_time(b) for a, b in enc.device_spans) / 1e3
    hdr = pkts[:3]
    outs = BatchDecoder(parse_info_header(hdr[0].data),
                        parse_setup_header(hdr[2].data),
                        device="cuda").decode_clip(
        [p.data for p in pkts[3:]], batch=8)
    nf = len(frames)
    mpix = nf * 1280 * 720 * 1.5 / 1e6
    log(f"[{what}] {nf} frames, all {n} packet SHA-256 equal the JAX "
        f"encoder's; {sum(len(p.data) for p in pkts[3:])} bytes; "
        f"{enc.nonbase_qi_blocks} coded blocks at a non-base qi; warm pass "
        f"{wall:.4f} s = {nf / wall:.2f} frames/s = {mpix / wall:.2f} "
        f"Mpix/s; host mode decision and gates {enc.host_decide_s:.4f} s, "
        f"host packing {enc.host_pack_s:.4f} s; device spans (CUDA events, "
        f"ME and plane encodes) {dev_s:.4f} s; PSNR "
        f"{_psnr(frames, outs):.3f} dB against the source; launches K1, "
        f"K2, KT, KR, KM, KL, KS {counts} = {counts[0] / (3 * nf):.0f} per "
        f"plane per frame (KS {counts[6] / (3 * nf):.0f}) | {smi}")
    return counts


def real_size_twopass(smi: str):
    """encode_clip_twopass of the 16 720p frames at 2 Mbit/s with a
    16-frame rate buffer (info quality 0, encoder qi 48): packets and
    metrics blob against the JAX encoder's list, more than one qi among
    the frames, the first GOP's closed loop at its frames' qis, and a warm
    pass with the launch counts reset just before it (pass 1 and pass 2
    each launch K1's encode entry, K2 and KT once per plane per frame, KL
    once per plane per frame whose qi's limit is above 0, from the frame
    qis of the two passes); the packets decoded on the card, KL once per
    plane per frame whose limit is above 0. Returns the counts (K1 encode
    entry, K2, KT, KR, KM, KL, KS) and KL's and KS's launches in the
    decode."""
    from theora_tpu_torch.decode.batch import BatchDecoder
    from theora_tpu_torch.headers import parse_info_header, \
        parse_setup_header
    from theora_tpu_torch.ops import loopfilter_cuda, mc_cuda

    mk = _load_testdata("make_hd720_enc")
    frames = mk.hd_frames()
    name, what = "hd720_2pass_k8_enc", "enc720p 2-pass"

    def encode(enc):
        return enc.encode_clip_twopass(frames, keyframe_freq=mk.HD_KF,
                                       target_bitrate=mk.HD_2PASS_RATE,
                                       buf_delay=mk.HD_2PASS_BUF)

    def make():
        return _encoder(1280, 720, 0, mk.HD_QI, "auto", quality=0)

    # The first run as encode_clip_twopass runs it, its passes called one
    # by one for pass 1's packets.
    enc = make()
    pass1, blob = enc.encode_clip_pass1(frames, keyframe_freq=mk.HD_KF,
                                        target_bitrate=mk.HD_2PASS_RATE)
    pkts = enc.encode_clip_pass2(frames, blob, keyframe_freq=mk.HD_KF,
                                 target_bitrate=mk.HD_2PASS_RATE,
                                 buf_delay=mk.HD_2PASS_BUF)
    _check_hashes(pkts, name, "first run", blob)
    qis, qis1 = _frame_qis(pkts), _frame_qis(pass1)
    if len(set(qis)) < 2:
        raise AssertionError(f"{what}: every frame at qi {qis[0]}")
    setup = parse_setup_header(pkts[2].data)
    filtered = [_kl_frames(setup, [p.data for p in pp[3:]])
                for pp in (pass1, pkts)]
    if not all(filtered):
        raise AssertionError(f"{what}: a pass filters no frame ({filtered})")
    _closed_loop(make(), frames[:mk.HD_KF], what, qis[:mk.HD_KF],
                 [p.data for p in pkts[3:3 + mk.HD_KF]])

    enc = make()
    enc.device_spans = []
    _reset_counts()
    t0 = time.perf_counter()
    pkts, blob = encode(enc)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    per = 2 * 3 * len(frames)
    # KM: pass 1's two 8-frame chunks and pass 2's two GOPs.
    counts = _read_counts(what, (per, per, per, 0,
                                 3 * (2 * len(frames) // mk.HD_KF)),
                          kl=3 * sum(filtered))
    n = _check_hashes(pkts, name, "warm run", blob)
    dev_s = sum(a.elapsed_time(b) for a, b in enc.device_spans) / 1e3
    hdr = pkts[:3]
    kl0 = loopfilter_cuda.loop_filter_plane.launches
    ks0 = mc_cuda.mc_recon.launches
    outs = BatchDecoder(parse_info_header(hdr[0].data), setup,
                        device="cuda").decode_clip(
        [p.data for p in pkts[3:]], batch=8)
    kl_dec = loopfilter_cuda.loop_filter_plane.launches - kl0
    ks_dec = mc_cuda.mc_recon.launches - ks0
    if kl_dec != 3 * filtered[1]:
        raise AssertionError(f"{what}: the decode's KL launches {kl_dec}; "
                             f"expected {3 * filtered[1]}")
    live = _live([p.data for p in pkts[3:]])
    if ks_dec != 3 * live:
        raise AssertionError(f"{what}: the decode's KS launches {ks_dec}; "
                             f"expected 3 per decoded frame, {live}")
    nf = len(frames)
    nbytes = sum(len(p.data) for p in pkts[3:])
    log(f"[{what}] {nf} frames at {mk.HD_2PASS_RATE} bit/s: all {n} lines "
        f"(packets and the pass-1 metrics blob) equal the JAX encoder's; "
        f"frame qis {qis} (pass 1 {qis1}; frames filtered {filtered}); "
        f"{nbytes} bytes = "
        f"{8 * nbytes * 30 / nf / 1e6:.3f} Mbit/s at 30 frames/s; warm run "
        f"(pass 1 + pass 2) {wall:.4f} s; host mode decision and gates "
        f"{enc.host_decide_s:.4f} s, host packing {enc.host_pack_s:.4f} s; "
        f"device spans {dev_s:.4f} s; PSNR {_psnr(frames, outs):.3f} dB; "
        f"launches K1, K2, KT, KR, KM, KL, KS {counts} = "
        f"{counts[1] / (6 * nf):.0f} per plane per frame in each pass; the "
        f"decode's KL launches {kl_dec}, KS launches {ks_dec} | {smi}")
    return counts, kl_dec, ks_dec


@contextlib.contextmanager
def _sync_debug():
    """torch.cuda.set_sync_debug_mode("error") inside: an implicit
    synchronisation (a blocking copy, .item(), nonzero) raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _sync_debug_findings() -> bool:
    """The mode must catch a blocking copy; returns whether an explicit
    event wait trips it too."""
    x = torch.ones(4, device="cuda")
    try:
        with _sync_debug():
            x.cpu()
    except RuntimeError:
        pass
    else:
        raise AssertionError("sync debug mode let a blocking copy pass")
    ev = torch.cuda.Event()
    ev.record()
    try:
        with _sync_debug():
            ev.synchronize()
    except RuntimeError:
        trips = True
    else:
        trips = False
    log(f"[sync debug] a blocking .cpu() raises; an explicit CUDA event "
        f"wait {'raises' if trips else 'does not raise'}")
    return trips


def _counts_all() -> dict:
    from theora_tpu_torch.ops import fdct_cuda, idct_cuda, loopfilter_cuda, \
        mc_cuda, me_cuda, postproc_cuda, qrd_cuda, trellis_cuda

    return {"K1 decode": idct_cuda.dequantize_idct_frames.launches,
            "K1 encode": (idct_cuda.idct_recon_choose.launches
                          + idct_cuda.mc_idct_recon_skip.launches),
            "K2": (fdct_cuda.fdct_quantize.launches
                   + fdct_cuda.mc_fdct_quantize.launches),
            "KT": trellis_cuda.trellis_quantize.launches,
            "KR": (qrd_cuda.fdct_quantize_rd.launches
                   + qrd_cuda.mc_fdct_quantize_rd.launches
                   + qrd_cuda.quantize_rd.launches),
            "KM": me_cuda.plan_with_gold.launches,
            "KL": loopfilter_cuda.loop_filter_plane.launches,
            "KS": sum(w.launches for w in mc_cuda.ENTRIES),
            "KP": (postproc_cuda.postprocess_plane.launches
                   + postproc_cuda.postprocess_frames.launches)}


def transcode_720p(smi: str) -> dict:
    """(a) The device-resident transcode of the 1280x720 test stream's 24
    data packets (decode batches of 8, three pipelined GOPs, qi 48,
    adaptive_quant "auto"): the 27 packets against the JAX list, and a
    warm pass with the launch counts reset just before it and every
    device->host copy counted at the port's own copy calls: none may be
    the size of a decoded frame. Returns the launch counts (K1 at both
    entries, K2, KT, KR, KM, KL, KS)."""
    from theora_tpu_torch import transfer
    from theora_tpu_torch.encode.gop import transcode_device

    mk = _load_testdata("make_hd720_enc")
    dec, datas = _open(mk.HD_TC_SOURCE)
    name = "hd720_transcode_q48_k8_enc"

    def run():
        return transcode_device(dec.info, dec.setup, datas,
                                keyframe_freq=mk.HD_TC_KF, qi=mk.HD_TC_QI)

    _check_hashes(run(), name, "first pass")
    _reset_counts()
    transfer.copy_log = []
    t0 = time.perf_counter()
    pkts = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    copies, transfer.copy_log = transfer.copy_log, None
    counts = _counts_all()
    n = _check_hashes(pkts, name, "warm pass")
    nf = len(datas)
    batches = -(-nf // mk.HD_TC_KF)
    want = {"K1 decode": 3 * batches, "K1 encode": 3 * nf, "K2": 3 * nf,
            "KT": 3 * nf, "KR": 0, "KM": 3 * batches, "KL": 0,
            "KS": 3 * nf, "KP": 0}
    if counts != want:
        raise AssertionError(f"transcode launches {counts}; expected {want}")
    # KS: the decode's entry once per plane per frame; on the encode side
    # it runs inside the fused entries, whose launches these are.
    from theora_tpu_torch.ops import fdct_cuda, idct_cuda

    _ks_decode_only("transcode", 3 * nf)
    if (idct_cuda.mc_idct_recon_skip.launches,
            fdct_cuda.mc_fdct_quantize.launches) != (3 * nf, 3 * nf):
        raise AssertionError("transcode: the encode ran standalone K1 or "
                             "K2 entries")
    KS_FUSED["transcode"] = 6 * nf
    frame_bytes = 1280 * 720 * 3 // 2
    if max(copies) >= frame_bytes:
        raise AssertionError(f"transcode: a device->host copy of "
                             f"{max(copies)} bytes, a decoded frame's "
                             f"{frame_bytes}")
    log(f"[transcode720p] {nf} packets, batches of {mk.HD_TC_KF}, qi "
        f"{mk.HD_TC_QI}, adaptive_quant auto: all {n} packet SHA-256 equal "
        f"the JAX transcode_device's; warm pass {wall:.4f} s = "
        f"{nf / wall:.2f} frames/s; launches {counts}; device->host "
        f"{len(copies)} copies, {sum(copies)} bytes, largest {max(copies)} "
        f"(a decoded frame: {frame_bytes}) | {smi}")
    return (counts["K1 decode"] + counts["K1 encode"], counts["K2"],
            counts["KT"], counts["KR"], counts["KM"], counts["KL"],
            counts["KS"])


def packet_decode_720p(smi: str) -> tuple:
    """(c) PacketDecoder on the 1280x720 test stream, packet by packet,
    every frame's SHA-256 against the committed list, and a warm pass with
    the launch counts reset (K1's decode entry once per plane per frame)
    timed beside a warm decode_clip(batch=8) of the same stream. Returns
    the launch counts (K1, K2, KT, KR, KM, KL, KS)."""
    from theora_tpu_torch.decode.scalar import PacketDecoder

    with open(os.path.join(TESTDATA, f"{HD_NAME}.sha256")) as f:
        want = f.read().split()
    dec, datas = _open(f"{HD_NAME}.ogv")

    def per_packet():
        pd = PacketDecoder(dec.info, dec.setup, device="cuda")
        outs = []
        for data in datas:
            if pd.decode_packet(data) != 0:
                raise AssertionError("the 720p stream has no dup packet")
            outs.append(pd.ycbcr_out())
        return outs

    def check(outs, what):
        got = [hashlib.sha256(_frame_bytes(o)).hexdigest() for o in outs]
        if got != want:
            bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
            raise AssertionError(f"{HD_NAME} {what}: frames {bad} differ")

    check(per_packet(), "per packet, first pass")
    _reset_counts()
    t0 = time.perf_counter()
    outs = per_packet()
    wall = time.perf_counter() - t0
    counts = _counts_all()
    check(outs, "per packet, warm pass")
    nf = len(datas)
    if counts != {"K1 decode": 3 * nf, "K1 encode": 0, "K2": 0, "KT": 0,
                  "KR": 0, "KM": 0, "KL": 0, "KS": 3 * nf, "KP": 0}:
        raise AssertionError(f"per-packet decode launches {counts}")
    _ks_decode_only("per-packet decode", 3 * nf)
    dec, _ = _open(f"{HD_NAME}.ogv")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    check(dec.decode_clip(datas, batch=8), "batch, warm pass")
    batch_wall = time.perf_counter() - t0
    log(f"[packet720p] {nf} frames decoded packet by packet, all SHA-256 "
        f"match; warm pass {wall:.4f} s = {1e3 * wall / nf:.3f} ms per "
        f"frame (decode_packet + ycbcr_out), decode_clip(batch=8) "
        f"{1e3 * batch_wall / nf:.3f} ms per frame; K1 launches "
        f"{counts['K1 decode']}, KS launches {counts['KS']} | {smi}")
    return (counts["K1 decode"], 0, 0, 0, 0, 0, counts["KS"])


def pipelined_vs_staged(smi: str) -> dict:
    """(b) The 720p q56 "auto" encode (16 frames, two 8-frame GOPs)
    through the pipelined encode_clip and, in turns with it, the same GOPs
    stage by stage through dispatch_me, complete_dispatch and finish_gop
    with the enqueue stages under the sync debug mode (an explicit event
    wait before complete_dispatch is scoped out if it trips the mode), 3
    pairs: every run's 19 packets against the JAX list. Also the 720p
    decode's dispatch_batch under the mode, and one chunk's coefficient
    download sparse (finish_gop's) against a dense copy. Returns the last
    stage-by-stage run's launch counts (K1 encode entry, K2, KT, KR,
    KM)."""
    from theora_tpu_torch import transfer

    trips = _sync_debug_findings()
    mk = _load_testdata("make_hd720_enc")
    frames = mk.hd_frames()
    nf = len(frames)
    name = "hd720_q56_k8_aq_enc"

    def make():
        return _encoder(1280, 720, 0, mk.AQ_QI, "auto")

    def pipelined():
        return make().encode_clip(frames, keyframe_freq=mk.HD_KF,
                                  clip_batch=8)

    def staged():
        enc = make()
        out = enc.flush_headers()
        for base in range(0, nf, mk.HD_KF):
            gfr = frames[base:base + mk.HD_KF]
            with _sync_debug():
                me_state = enc.dispatch_me(gfr)
            if trips and me_state.plan is not None:
                me_state.plan.wait()
            with _sync_debug():
                state = enc.complete_dispatch(me_state)
            datas, _ = enc.finish_gop(state)
            enc._emit(out, datas, [True] + [False] * (len(gfr) - 1), base,
                      nf)
        return out

    walls = {"pipelined": [], "staged": []}
    for what, fn in (("pipelined", pipelined), ("staged", staged)):
        _check_hashes(fn(), name, f"{what}, first run")
    per = 3 * nf
    for _ in range(3):
        for what, fn in (("pipelined", pipelined), ("staged", staged)):
            _reset_counts()
            t0 = time.perf_counter()
            pkts = fn()
            torch.cuda.synchronize()
            walls[what].append(time.perf_counter() - t0)
            launches = _read_counts(f"enc720p {what}",
                                    (per, per, per, 0,
                                     3 * (nf // mk.HD_KF)))
            _check_hashes(pkts, name, what)
    log(f"[pipelined] 720p q56 auto, {nf} frames: 19/19 packets both ways "
        f"in all runs; walls in turns pipelined "
        f"{[round(w, 4) for w in walls['pipelined']]} s, stage by stage "
        f"{[round(w, 4) for w in walls['staged']]} s; no sync debug error "
        f"in the enqueue stages | {smi}")

    dec, datas = _open(f"{HD_NAME}.ogv")
    with _sync_debug():
        for b in range(0, len(datas), 8):
            dec.dispatch_batch(datas[b:b + 8])
    torch.cuda.synchronize()
    log("[sync debug] the 720p decode's dispatch_batch (the transcode's "
        "decode stage) raises no sync debug error")

    # One 8-frame chunk's coefficients on an idle card: finish_gop's
    # sparse copy (nonzero values and their places found on the side
    # stream, copied, then placed on the host) against a dense int16 copy
    # of the same tensors.
    enc = make()
    st = enc.complete_dispatch(enc.dispatch_me(frames[:mk.HD_KF]))
    st.download.wait()
    g = enc.g
    copy_s, place_s, dense_s = [], [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nonzeros = enc._coefficients(st.qout, st.download.event)
        t1 = time.perf_counter()
        sparse = np.zeros((mk.HD_KF, g.nfrags, 64), np.int16)
        for idx, vals in nonzeros:
            sparse.reshape(-1)[idx] = vals
        t2 = time.perf_counter()
        copy_s.append(t1 - t0)
        place_s.append(t2 - t1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dense = transfer.Download(st.qout).wait()
        dense_s.append(time.perf_counter() - t0)
    for pli, d in enumerate(dense):
        pl = g.planes[pli]
        if not np.array_equal(
                sparse[:, pl.froffset:pl.froffset + pl.nfrags], d):
            raise AssertionError("sparse and dense coefficients differ")
    nvals = sum(v.size for _, v in nonzeros)
    dense_bytes = sum(q.numel() * 2 for q in st.qout)

    def ms(v):
        return f"{sorted(v)[len(v) // 2] * 1e3:.3f}"

    log(f"[download] one 8-frame 720p q56 chunk's coefficients, medians of "
        f"5 on the host clock: sparse {nvals} values = {6 * nvals} bytes, "
        f"found and copied {ms(copy_s)} ms + placed on the host "
        f"{ms(place_s)} ms; dense {dense_bytes} bytes copied "
        f"{ms(dense_s)} ms | {smi}")
    return launches


def mesh_kernels(smi: str, device) -> dict:
    """10 (a): K2, KT, KR and K1's encode entry over 3 segments of the
    1280x720 luma plane's 14,400 blocks, each segment with its own qi
    triple, lambdas and per-block lambda scales
    (tools/bench_segments.py): every output of each kernel's one launch
    equals its plain version on the same inputs and 3 launches of one
    segment each; the one launch timed beside the 3. Returns {kernel:
    (one launch ms, 3 launches ms)}."""
    from theora_tpu_torch.tools import bench_segments as bs

    c = bs.segment_case(np.random.default_rng(bs.SEED), 14400, 3, device)
    args = bs.kernel_args(c)
    one = bs.run_chain(c, args)
    plain = bs.run_chain(c, args, bs.plains())
    sep = bs.run_separately(c)
    torch.cuda.synchronize()
    err = max(int((g.int() - w.int()).abs().max())
              for k in one for g, w in zip(one[k], plain[k]))
    for what, other in (("plain", plain), ("3 launches", sep)):
        bad = bs.differ(one, other)
        if bad:
            raise AssertionError(f"mesh kernels over 3 segments != {what}: "
                                 f"{bad}")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    times = bs.time_segments(c, flush)
    for k, (t1, t3) in times.items():
        log(f"[mesh kernels] {k} over 3 x 14400 blocks (qi triples "
            f"{c['qis']}, lambdas and lambda scales per segment): one "
            f"launch == plain == 3 launches of one segment (max |err| "
            f"{err}, tolerance 0); one launch {t1:.4f} ms, 3 launches "
            f"{t3:.4f} ms | {smi}")
    return times


def mesh_720p(smi: str) -> tuple:
    """10 (b): encode_clip_mesh of the 16 720p frames at q56 "auto", a
    keyframe every 8, on a gop axis of 2 (both GOPs in one dispatch):
    the 19 packets against hd720_q56_k8_aq_enc.sha256, and a warm pass
    with the launch counts reset just before it (K1's encode entry, K2
    and KT once per plane per frame step: 3 x 8 = 24 each, KR none).
    Then KR's path: the two GOPs at q48 through MeshGopEncoder.encode_gops
    at speed level 2 against hd720_q48_k8_sp2_enc.sha256, counts reset
    just before it (K1's encode entry and KR's fused entry 24 each, K2 and
    KT none). KM
    runs 3 times in each (one plan call per batch). Returns the two runs'
    counts (K1 encode entry, K2, KT, KR, KM, KL, KS)."""
    import types

    from theora_tpu_torch.info import TheoraInfo
    from theora_tpu_torch.parallel.gop import MeshGopEncoder, \
        encode_clip_mesh, make_mesh

    mk = _load_testdata("make_hd720_enc")
    frames = mk.hd_frames()
    info = TheoraInfo(frame_width=1280, frame_height=720, pic_width=1280,
                      pic_height=720, quality=mk.AQ_QI)
    name = "hd720_q56_k8_aq_enc"

    def run():
        return encode_clip_mesh(frames, info, make_mesh(2),
                                keyframe_freq=mk.HD_KF, qi=mk.AQ_QI)

    _check_hashes(run(), name, "mesh, gop axis 2, first pass")
    _reset_counts()
    t0 = time.perf_counter()
    pkts = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    per = 3 * mk.HD_KF
    counts = _read_counts("mesh 720p", (per, per, per, 0, 3))
    n = _check_hashes(pkts, name, "mesh, gop axis 2, warm pass")
    log(f"[mesh720p] q56 auto, 16 frames, keyframe every 8, gop axis 2: "
        f"all {n} packet SHA-256 equal the JAX encoder's list; warm pass "
        f"{wall:.4f} s; launches K1, K2, KT, KR, KM, KL, KS {counts} (one "
        f"per plane per frame step of the 2 GOPs, KS none of its own; KM 3 "
        f"for the one plan) | {smi}")
    info48 = TheoraInfo(frame_width=1280, frame_height=720, pic_width=1280,
                        pic_height=720, quality=mk.HD_QI)
    enc = MeshGopEncoder(make_mesh(2), info48, qi=mk.HD_QI)
    enc.base.set_splevel(2)
    _reset_counts()
    datas = enc.encode_gops([frames[:mk.HD_KF], frames[mk.HD_KF:]])
    torch.cuda.synchronize()
    sp2 = _read_counts("mesh 720p speed 2", (per, 0, 0, per, 3))
    n = _check_hashes(enc.base.flush_headers() + [
        types.SimpleNamespace(data=d) for gop in datas for d in gop],
        "hd720_q48_k8_sp2_enc", "mesh, gop axis 2, speed 2")
    log(f"[mesh720p] q48 speed 2 (KR over 2 segments), the two GOPs in one "
        f"encode_gops batch: all {n} packet SHA-256 equal the JAX encoder's "
        f"list; launches K1, K2, KT, KR, KM, KL, KS {sp2} | {smi}")
    return counts, sp2


def mesh_vs_sequential(smi: str) -> dict:
    """10 (c): 24 720p frames (tools/profile_encode.py:hd720_frames) at
    q48 "auto", a keyframe every 8, through encode_clip_mesh on a gop axis
    of 3 (the three GOPs in one dispatch) and the sequential
    GopEncoder.encode_clip (clip_batch 8), in turns, 3 pairs: the 27
    packets of every run equal, each run's kernel launches counted from
    0, then one traced pass each way for the device kernels launched per
    plane per frame. No claim. Returns {way: launch counts (K1 encode
    entry, K2, KT, KR, KM, KL, KS)}."""
    from theora_tpu_torch.encode.gop import GopEncoder
    from theora_tpu_torch.info import TheoraInfo
    from theora_tpu_torch.parallel.gop import encode_clip_mesh, make_mesh
    from theora_tpu_torch.tools.profile_encode import device_launches, \
        hd720_frames, traced

    frames = hd720_frames(24)
    nf, qi, kf = len(frames), 48, 8
    info = TheoraInfo(frame_width=1280, frame_height=720, pic_width=1280,
                      pic_height=720, quality=qi)
    ways = {
        "mesh": (lambda: encode_clip_mesh(frames, info, make_mesh(3),
                                          keyframe_freq=kf, qi=qi),
                 (3 * kf, 3 * kf, 3 * kf, 0, 3)),
        "sequential": (lambda: GopEncoder(info, qi=qi).encode_clip(
            frames, keyframe_freq=kf, clip_batch=8),
            (3 * nf, 3 * nf, 3 * nf, 0, 3 * (nf // kf))),
    }
    ref = [p.data for p in ways["sequential"][0]()]
    if len(ref) != 3 + nf:
        raise AssertionError(f"sequential 24 frames: {len(ref)} packets")
    walls = {w: [] for w in ways}
    counts = {}
    for _ in range(3):
        for way, (fn, want) in ways.items():
            _reset_counts()
            t0 = time.perf_counter()
            pkts = fn()
            torch.cuda.synchronize()
            walls[way].append(time.perf_counter() - t0)
            counts[way] = _read_counts(f"720p 24 frames {way}", want)
            if [p.data for p in pkts] != ref:
                raise AssertionError(f"720p 24 frames {way}: packets differ "
                                     f"from the sequential encode's")
    per_ppf = {}
    for way, (fn, _) in ways.items():
        _, events, wall = traced(fn)
        launches, busy = device_launches(events)
        per_ppf[way] = launches / (3 * nf)
        log(f"[mesh vs sequential] {way}: traced pass {wall:.4f} s, "
            f"{launches} device kernels = {per_ppf[way]:.1f} per plane per "
            f"frame, device busy {busy:.5f} s | {smi}")
    log(f"[mesh vs sequential] 720p q48 auto, {nf} frames, keyframe every "
        f"{kf}: all {len(ref)} packets equal both ways in all 3 pairs; "
        f"walls in turns mesh (gop axis 3) "
        f"{[round(w, 4) for w in walls['mesh']]} s, sequential "
        f"{[round(w, 4) for w in walls['sequential']]} s; launches K1, K2, "
        f"KT, KR, KM, KL, KS mesh {counts['mesh']}, sequential "
        f"{counts['sequential']}; "
        f"device kernels per plane per frame mesh {per_ppf['mesh']:.1f}, "
        f"sequential {per_ppf['sequential']:.1f} (no claim) | {smi}")
    return counts


_MESH_RANKS_WORKER = r"""
import hashlib, importlib.util, json, os, sys, time
root, rank, world, port, out = sys.argv[1], int(sys.argv[2]), \
    int(sys.argv[3]), sys.argv[4], sys.argv[5]
sys.path.insert(0, root)
import torch
import torch.distributed as dist
spec = importlib.util.spec_from_file_location(
    "mk", os.path.join(root, "testdata", "make_hd720_enc.py"))
mk = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mk)
from theora_tpu_torch.info import TheoraInfo
from theora_tpu_torch.ops import fdct_cuda, idct_cuda, loopfilter_cuda, \
    mc_cuda, me_cuda, qrd_cuda, trellis_cuda
from theora_tpu_torch.parallel.gop import MeshGopEncoder, \
    encode_clip_mesh, make_mesh
WRAPPERS = (idct_cuda.mc_idct_recon_skip, fdct_cuda.mc_fdct_quantize,
            trellis_cuda.trellis_quantize, qrd_cuda.mc_fdct_quantize_rd,
            me_cuda.plan_with_gold, loopfilter_cuda.loop_filter_plane,
            idct_cuda.dequantize_idct_frames, qrd_cuda.quantize_rd,
            *mc_cuda.ENTRIES, idct_cuda.idct_recon_choose,
            fdct_cuda.fdct_quantize, qrd_cuda.fdct_quantize_rd)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=world, rank=rank)
frames = mk.hd_frames()
kf = mk.HD_KF
gops = [frames[:kf], frames[kf:]]


def info(qi):
    return TheoraInfo(frame_width=1280, frame_height=720, pic_width=1280,
                      pic_height=720, quality=qi)


def q56_auto(mesh):
    return [p.data for p in encode_clip_mesh(frames, info(mk.AQ_QI), mesh,
                                             keyframe_freq=kf, qi=mk.AQ_QI)]


def batches(mesh, qi, setup):
    enc = MeshGopEncoder(mesh, info(qi), qi=qi)
    setup(enc.base)
    G = mesh.shape["gop"]
    return [p.data for p in enc.base.flush_headers()] + [
        d for b0 in range(0, len(gops), G)
        for pk in enc.encode_gops(gops[b0:b0 + G]) for d in pk]


CASES = (
    ("hd720_q56_k8_aq_enc", 2, 2, q56_auto),
    ("hd720_q48_k8_sp2_enc", 2, 2,
     lambda m: batches(m, mk.HD_QI, lambda b: b.set_splevel(2))),
    ("hd720_q48_k8_enc", 2, 1,
     lambda m: batches(m, mk.HD_QI,
                       lambda b: setattr(b, "adaptive_quant", False))),
)
res = {"device": None, "cases": []}
for name, n, frag, run in CASES:
    mesh = make_mesh(n, frag_axis=frag)
    res["device"] = str(mesh.device)
    t0 = time.perf_counter()
    first = run(mesh)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    for c in (mesh.ranks.frag, mesh.ranks.everyone):
        c.stats.clear()
    torch.cuda.synchronize()
    for w in WRAPPERS:
        w.launches = 0
    dist.barrier()
    t0 = time.perf_counter()
    warm = run(mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res["cases"].append({
        "name": name, "shape": mesh.shape, "cold": cold, "wall": wall,
        "same": first == warm,
        "hashes": [hashlib.sha256(d).hexdigest() for d in warm],
        "counts": [w.launches for w in WRAPPERS],
        "route": mesh.ranks.frag.route, "frag": mesh.ranks.frag.stats,
        "everyone": mesh.ranks.everyone.stats})
# The frag gather's transport alone: one 720p luma step's [7200, 65]
# uint8 card tensor through the {1, 2} mesh's frag group, both ranks
# entering together after a barrier, 20 times.
frag = make_mesh(2, frag_axis=2).ranks.frag
step = torch.zeros((7200, 65), dtype=torch.uint8, device=frag.device)
times = []
for _ in range(21):
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    frag.all_gather(step)
    torch.cuda.synchronize()
    times.append(time.perf_counter() - t0)
res["transport_ms"] = sorted(1e3 * t for t in times[1:])
dist.barrier()
dist.destroy_process_group()
with open(f"{out}.{rank}", "w") as f:
    json.dump(res, f)
"""


def mesh_ranks_720p(smi: str) -> dict:
    """10d: the mesh over torch.distributed ranks (parallel/gop.py with
    parallel/ranks.py) in two local "gloo" processes, both on cuda:0 (the
    default device of each rank): the 16 720p frames at q56 "auto" at
    {gop 1, frag 2} (encode_clip_mesh, each rank half of every frame's
    fragments) against hd720_q56_k8_aq_enc.sha256, at q48 speed 2 at {1,
    2} (encode_gops per GOP, KR's fused entry on the slices) against
    hd720_q48_k8_sp2_enc.sha256, and at q48 "off" at {2, 1} (one GOP per
    rank in one encode_gops batch) against hd720_q48_k8_enc.sha256: every
    packet on every rank, a first pass and a warm one with the launch
    counts reset just before it. Per rank: launches of K1 (encode entry),
    K2, KT, KR (fused entry) and KM, each above 0 where the path runs it
    and exact (3 x 8 per GOP per plane per frame step, KM 3 per plan), KL,
    K1's decode entry and KR's standalone entry 0 (no filter at q >=
    47); the wall of each case; the gather's time per plane per frame
    step and its route (the gloo group takes the card's tensors through
    pinned host buffers), and that gather's transport alone on one luma
    step's bytes, both ranks entering after a barrier. Every process it
    starts is waited for or killed. Returns {path: [per-rank counts (K1
    encode entry, K2, KT, KR, KM, KL, KS)]}."""
    import socket
    import tempfile

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = str(sk.getsockname()[1])
    world = 2
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        out = os.path.join(tmp, "ranks")
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", _MESH_RANKS_WORKER, ROOT, str(r),
             str(world), port, out], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT) for r in range(world)]
        try:
            logs = [p.communicate(timeout=420)[0].decode(errors="replace")
                    for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        span = time.perf_counter() - t0
        if any(p.returncode for p in procs):
            raise AssertionError(f"mesh rank workers failed: "
                                 f"{[lg[-2500:] for lg in logs]}")
        res = []
        for r in range(world):
            with open(f"{out}.{r}") as f:
                res.append(json.load(f))
    per = 3 * 8
    want = {"hd720_q56_k8_aq_enc": (2 * per, 2 * per, 2 * per, 0, 6, 0),
            "hd720_q48_k8_sp2_enc": (2 * per, 0, 0, 2 * per, 6, 0),
            "hd720_q48_k8_enc": (per, per, per, 0, 3, 0)}
    paths = {}
    for i, name in enumerate(want):
        by_rank = []
        for r, rr in enumerate(res):
            c = rr["cases"][i]
            _check_listed(c["hashes"], name,
                          f"mesh over ranks {c['shape']}, rank {r}")
            if not c["same"]:
                raise AssertionError(f"{name} rank {r}: the two passes "
                                     f"differ")
            counts = tuple(c["counts"][:6])
            # KS (mc_residual, skip_place, skip_rows, place_rows,
            # mc_recon): over a frag group its place entry after the
            # gather, once per plane per frame step; else nothing of its
            # own (its work runs in K1's, K2's and KR's fused entries,
            # the first, second and fourth counts). The standalone K1,
            # K2 and KR entries (the last three) never.
            steps = counts[0]
            frag = c["shape"]["frag"] > 1
            ks_want = [0, 0, 0, steps if frag else 0, 0]
            if counts != want[name] or any(c["counts"][6:8]) or \
                    c["counts"][8:13] != ks_want or any(c["counts"][13:]):
                raise AssertionError(
                    f"{name} rank {r}: launches K1 (fused encode entry), K2 "
                    f"(fused), KT, KR (fused), KM, KL, K1 decode, KR "
                    f"standalone, KS entries, K1, K2 and KR standalone "
                    f"{c['counts']}; expected {want[name]}, 0, 0, KS "
                    f"{ks_want} and 0, 0, 0")
            counts += (sum(ks_want),)
            KS_FUSED[f"{name} rank {r}"] = (counts[0] + counts[1]
                                            + counts[3])
            step = c["frag"].get("step", [0, 0.0, 0])
            chunk = c["frag"].get("chunk", [0, 0.0, 0])
            exch = c["everyone"].get("exchange", [0, 0.0, 0])
            gather = (f"frag gather per plane per frame step "
                      f"{1e3 * step[1] / step[0]:.4f} ms over {step[0]} "
                      f"steps ({step[2] // max(step[0], 1)} B per rank "
                      f"each), chunk gathers {chunk[0]} in "
                      f"{1e3 * chunk[1]:.3f} ms ({chunk[2]} B)"
                      if step[0] else "no frag gather (frag axis 1)")
            log(f"[mesh ranks] {name} at {c['shape']}, rank {r} on "
                f"{rr['device']}, route {c['route']}: all "
                f"{len(c['hashes'])} packets equal the list in both passes; "
                f"first pass {c['cold']:.4f} s, warm {c['wall']:.4f} s; "
                f"launches K1, K2, KT, KR, KM, KL, KS {counts}; {gather}; "
                f"packet exchanges {exch[0]} in {1e3 * exch[1]:.3f} ms | "
                f"{smi}")
            by_rank.append(counts)
        paths[name] = by_rank
    for r, rr in enumerate(res):
        t = rr["transport_ms"]
        log(f"[mesh ranks] frag gather transport alone, rank {r} "
            f"({res[0]['cases'][0]['route']}): 7200 x 65 B per rank after a "
            f"barrier, 20 calls: median {t[len(t) // 2]:.4f} ms, min "
            f"{t[0]:.4f}, max {t[-1]:.4f} | {smi}")
    log(f"[mesh ranks] 2 gloo ranks on one card, three cases: {span:.2f} s "
        f"with the processes' start | {smi}")
    return paths


@contextlib.contextmanager
def _plain_kernels():
    """Within the block, the pipeline cores run the kernels' plain
    PyTorch versions (ops/transforms.py) on the card's tensors."""
    import types

    from theora_tpu_torch import pipeline
    from theora_tpu_torch.ops import transforms

    plain = types.SimpleNamespace(
        fdct_quantize=transforms.fdct_quantize,
        dequantize_idct_frames=transforms.dequantize_idct_frames)
    saved = pipeline.fdct_cuda, pipeline.idct_cuda
    pipeline.fdct_cuda = pipeline.idct_cuda = plain
    try:
        yield
    finally:
        pipeline.fdct_cuda, pipeline.idct_cuda = saved


def _k1_k2_counts() -> tuple:
    """(K1's launches at both entries, K2's) since _reset_counts."""
    from theora_tpu_torch.ops import fdct_cuda, idct_cuda

    return (idct_cuda.dequantize_idct_frames.launches
            + idct_cuda.idct_recon_choose.launches,
            fdct_cuda.fdct_quantize.launches)


def _to_blocks(plane: np.ndarray) -> np.ndarray:
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3) \
        .reshape(-1, 8, 8)


def intra_core_720p(smi: str, device) -> tuple:
    """11 (a): pipeline.intra_encode_core on 24 720p frames
    (tools/profile_encode.py:hd720_frames) at qi 48, batched as the JAX
    package's bench.py batches its compute core: the luma blocks [24,
    14400] in one call, Cb and Cr [48, 3600] in another. Each call equals
    its plain version on the card (the same core with the kernels' plain
    versions) exactly and launches K2 once and K1's decode entry once
    (counts reset just before); the two calls timed with CUDA events,
    Mpix/s over 24 x 1,382,400 pixels, beside K2 and K1 alone at those
    block counts and their bounds (tools/bench_fdct.py:k2_bound,
    tools/bench_idct.py:k1_bound). Then inter_encode_core (14,400 blocks,
    a third intra) and recon_core (14,400 blocks of a padded 720p plane,
    three dequant rows, every reference kind) once each against their
    plain versions. Returns ((K1, K2) launches of the two timed-path
    calls, {"K1": ..., "K2": ...} times and bounds)."""
    from theora_tpu_torch import pipeline
    from theora_tpu_torch.ops import fdct_cuda, idct_cuda
    from theora_tpu_torch.quant import dequant_tables_init
    from theora_tpu_torch.tables import DEF_QUANT_INFO
    from theora_tpu_torch.tools import bench_fdct as bf, bench_idct as bi
    from theora_tpu_torch.tools.bench_trellis import event_ms
    from theora_tpu_torch.tools.profile_encode import hd720_frames

    qi = 48
    frames = hd720_frames(24)
    dq = dequant_tables_init(DEF_QUANT_INFO)
    yb = torch.from_numpy(np.stack([_to_blocks(f[0]) for f in frames])
                          ).to(device)
    cb = torch.from_numpy(np.stack([_to_blocks(f[1]) for f in frames]
                                   + [_to_blocks(f[2]) for f in frames])
                          ).to(device)
    dq_y = torch.from_numpy(dq[qi, 0, 0].astype(np.int32)).to(device)
    dq_c = torch.from_numpy(dq[qi, 1, 0].astype(np.int32)).to(device)
    calls = (("luma", yb, dq_y), ("chroma", cb, dq_c))
    err = 0
    launches = (0, 0)
    for what, blocks, d in calls:
        _reset_counts()
        got = pipeline.intra_encode_core(blocks, d)
        torch.cuda.synchronize()
        c = _k1_k2_counts()
        if c != (1, 1) or any(_counts_all()[k] for k in ("KM", "KL", "KS")):
            raise AssertionError(f"intra core {what}: K1, K2 launches {c}; "
                                 f"expected (1, 1) and no KM, KL or KS "
                                 f"launch")
        launches = (launches[0] + c[0], launches[1] + c[1])
        with _plain_kernels():
            want = pipeline.intra_encode_core(blocks, d)
        for g, w in zip(got, want):
            err = max(err, int((g.int() - w.int()).abs().max()))
            if not torch.equal(g, w):
                raise AssertionError(f"intra core {what} != plain (max |d| "
                                     f"{err})")
        log(f"[intra core] {what} {tuple(blocks.shape[:2])} blocks at qi "
            f"{qi}: qdct and recon == plain on the card (max |err| {err}, "
            f"tolerance 0); launches K1 {c[0]}, K2 {c[1]}; "
            f"{int((got[0][..., 1:] == 0).all(-1).sum())} DC-only blocks")

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)

    def core():
        for _, blocks, d in calls:
            pipeline.intra_encode_core(blocks, d)

    def core_plain():
        with _plain_kernels():
            core()

    ms = event_ms(core, 20, flush)
    plain_ms = event_ms(core_plain, 3, flush)
    mpix = 24 * 1382400 / 1e6
    kern = {"K1": {"ms": 0.0, "bound_ms": 0.0},
            "K2": {"ms": 0.0, "bound_ms": 0.0}}
    for _, blocks, d in calls:
        n = blocks.shape[0] * blocks.shape[1]
        res = (blocks.reshape(-1, 64).to(torch.int16) - 128).contiguous()
        d16 = d.to(torch.int16)
        k2_args = (res, d16.expand(1, 2, 64).contiguous(),
                   torch.zeros(n, dtype=torch.uint8, device=device))
        q16 = fdct_cuda.fdct_quantize(*k2_args)[0][0]
        tab = torch.zeros((1, 3, 2, 64), dtype=torch.int16, device=device)
        tab[0] = d16
        zeros = torch.zeros(n, dtype=torch.int32, device=device)
        k1_args = (q16, q16[:, 0].contiguous(), tab, zeros, k2_args[2],
                   k2_args[2], (q16[:, 1:] == 0).all(dim=1))
        for key, fn, b in (
                ("K2", lambda: fdct_cuda.fdct_quantize(*k2_args),
                 bf.k2_bound(k2_args)),
                ("K1", lambda: idct_cuda.dequantize_idct_frames(*k1_args),
                 bi.k1_bound("decode", k1_args))):
            kern[key]["ms"] += event_ms(fn, 20, flush)
            kern[key]["bound_ms"] += b["bound_ms"]
            kern[key].setdefault("bound_by", []).append(b["bound_by"])
    for key in kern:
        kern[key]["blocks"] = [24 * 14400, 48 * 3600]
    log(f"[intra core] 24 frames 1280x720 at qi {qi}, two calls (luma 24 x "
        f"14400 blocks, Cb+Cr 48 x 3600): {ms:.4f} ms = "
        f"{mpix / (ms * 1e-3):.2f} Mpix/s ({mpix:.4f} Mpix); plain "
        f"{plain_ms:.4f} ms = {mpix / (plain_ms * 1e-3):.2f} Mpix/s; K2 "
        f"alone {kern['K2']['ms']:.4f} ms beside its bound "
        f"{kern['K2']['bound_ms']:.4f} ms ({kern['K2']['bound_by']}); K1's "
        f"decode entry alone {kern['K1']['ms']:.4f} ms beside its bound "
        f"{kern['K1']['bound_ms']:.4f} ms ({kern['K1']['bound_by']}) | {smi}")

    rng = np.random.default_rng(20261017)
    n = 14400
    cur = torch.from_numpy(rng.integers(0, 256, (n, 8, 8), dtype=np.uint8))
    pred = torch.from_numpy(rng.integers(0, 256, (n, 8, 8), dtype=np.uint8))
    intra = torch.from_numpy(rng.random(n) < 0.3)
    dq_e = torch.from_numpy(dq[qi, 0, 1].astype(np.int32))
    iargs = [a.to(device) for a in (cur, pred, intra, dq_y.cpu(), dq_e)]
    h, w, pad = 720, 1280, 32
    hp, wp = h + 2 * pad, w + 2 * pad
    planes = [torch.from_numpy(rng.integers(0, 256, (hp, wp),
                                            dtype=np.uint8))
              for _ in range(3)]
    fr = rng.permutation((h // 8) * (w // 8))[:n]
    by = torch.from_numpy((fr // (w // 8) * 8 + pad).astype(np.int32))
    bx = torch.from_numpy((fr % (w // 8) * 8 + pad).astype(np.int32))
    coeffs = rng.integers(-40, 41, (n, 64)).astype(np.int32)
    coeffs[::5, 1:] = 0
    rows = np.stack([dq[q, 0, t] for q, t in ((48, 0), (48, 1), (56, 1))]
                    ).astype(np.int32)
    deq = rows[rng.integers(0, 3, n)]
    rargs = [a.to(device) for a in (
        *planes, by, bx, torch.from_numpy(coeffs), torch.from_numpy(deq),
        torch.from_numpy(rng.integers(-300, 300, n).astype(np.int32)),
        torch.from_numpy(deq[:, 0].copy()),
        torch.from_numpy((coeffs[:, 1:] == 0).all(axis=1)),
        torch.from_numpy(rng.integers(0, 3, n).astype(np.int32)),
        *[torch.from_numpy(rng.integers(-16, 17, n).astype(np.int32))
          for _ in range(4)],
        torch.from_numpy(rng.random(n) < 0.5))]
    for name, fn, args, want_c in (
            ("inter_encode_core", pipeline.inter_encode_core, iargs, (0, 1)),
            ("recon_core", pipeline.recon_core, rargs, (1, 0))):
        _reset_counts()
        got = fn(*args)
        torch.cuda.synchronize()
        c = _k1_k2_counts()
        with _plain_kernels():
            want = fn(*args)
        if c != want_c or not torch.equal(got, want):
            raise AssertionError(f"{name}: launches K1, K2 {c} (expected "
                                 f"{want_c}) or kernel != plain")
        log(f"[intra core] {name}, {n} blocks: == plain on the card "
            f"(tolerance 0); launches K1 {c[0]}, K2 {c[1]}")
    return launches, kern


def intra_encode_720p(smi: str) -> tuple:
    """11 (b): BatchIntraEncoder(device="cuda") on the 16 720p frames at
    q48 (every frame one qi, so every frame takes K2's results) as one
    batch: the 19 packets against hd720_intra_q48_enc.sha256 (the JAX
    host Encoder's at keyframe_freq 1, which JAX's TpuBatchIntraEncoder
    also gives: make_hd720_enc.py CHECKS), a warm pass with the counts
    reset just before it (K2 3 launches, one per plane index; K1, KT, KR
    none), timed as a wall, the frames' gates, the device part (upload,
    K2, one download) and the host's per-frame stages; PSNR of the port's decode of the
    packets against the source. Returns (K1, K2) launches."""
    from theora_tpu_torch.decode.batch import BatchDecoder
    from theora_tpu_torch.encode.intra import BatchIntraEncoder
    from theora_tpu_torch.headers import parse_info_header, \
        parse_setup_header
    from theora_tpu_torch.info import TheoraInfo

    mk = _load_testdata("make_hd720_enc")
    frames = mk.hd_frames()
    name = "hd720_intra_q48_enc"
    info = TheoraInfo(frame_width=1280, frame_height=720, pic_width=1280,
                      pic_height=720, quality=mk.HD_INTRA_QI)

    def make():
        return BatchIntraEncoder(info, device="cuda")

    enc = make()
    _check_hashes(enc.flush_headers() + enc.encode(frames), name,
                  "first pass")
    enc = make()
    hdr = enc.flush_headers()
    _reset_counts()
    t0 = time.perf_counter()
    pkts = enc.encode(frames)
    wall = time.perf_counter() - t0
    counts = _read_counts("intra 720p", (0, 3, 0, 0, 0), fused=False)
    n = _check_hashes(hdr + pkts, name, "warm pass")
    triple = sum(bool(p.data[1] & 0x80) for p in pkts)
    if triple:
        raise AssertionError(f"intra 720p q48: {triple} frames engage the "
                             f"qi triple; the device path is not measured")
    dec = BatchDecoder(parse_info_header(hdr[0].data),
                       parse_setup_header(hdr[2].data), device="cuda")
    psnr = _psnr(frames, dec.decode_clip([p.data for p in pkts], batch=8))
    host = enc.timing["host_s"]
    nf = len(frames)
    log(f"[intra720p] q48, 16 frames as one batch: all {n} packet SHA-256 "
        f"equal the JAX host Encoder's list; no frame engages the intra "
        f"triple (q48 'auto' is in its saturation region only for noise-"
        f"like or mixed frames), so every frame takes K2's results; warm "
        f"pass {wall:.4f} s = {nf / wall:.2f} frames/s; adaptive-quant "
        f"gates {enc.timing['gates_s']:.4f} s; device (upload, "
        f"K2 x 3, one download) {enc.timing['device_s']:.4f} s; host "
        f"stages {sum(host):.4f} s ({1e3 * sum(host) / nf:.2f} ms per frame"
        f", max {1e3 * max(host):.2f}); launches K1, K2, KT, KR, KM, KL, "
        f"KS "
        f"{counts}; "
        f"PSNR {psnr:.3f} dB; {sum(len(p.data) for p in pkts)} bytes | "
        f"{smi}")
    return counts[0], counts[1]


def intra_small() -> None:
    """11 (c): BatchIntraEncoder(device="cuda") on the test cases
    (make_hd720_enc.py INTRA_CASES) against their lists, the F5 case
    (a target bitrate: K2 per frame at its own qi) included."""
    from theora_tpu_torch.encode.intra import BatchIntraEncoder
    from theora_tpu_torch.info import TheoraInfo

    mk = _load_testdata("make_hd720_enc")

    def run(case, rate=0):
        kind, w, h, fmt, qi, mode, splevel = mk.INTRA_CASES[case]
        b = BatchIntraEncoder(TheoraInfo(
            frame_width=w, frame_height=h, pic_width=w, pic_height=h,
            quality=qi, pixel_fmt=fmt, target_bitrate=rate), device="cuda")
        b.enc.adaptive_quant = mode
        if splevel:
            b.enc.set_splevel(splevel)
        return b.flush_headers() + b.encode(mk.intra_frames(kind))

    for name, cases in (("intra64x48_enc", mk.INTRA_SMALL),
                        ("intra96x64_aq_enc", mk.INTRA_AQ)):
        n = _check_hashes([p for c in cases for p in run(c)], name,
                          "cases")
        log(f"[{name}] cases {list(cases)}: all {n} packets equal the JAX "
            f"host Encoder's (SHA-256)")
    pkts = run(mk.F5_CASE, mk.F5_RATE)
    n = _check_hashes(pkts, "intra64x48_f5_enc", "F5")
    log(f"[intra64x48_f5_enc] q40 at {mk.F5_RATE} bit/s: all {n} packets "
        f"equal the JAX host Encoder's (JAX's batch differs: F5); frame "
        f"qis {_frame_qis(pkts)}")


def _host_info(mk, case: str):
    from theora_tpu_torch.info import TheoraInfo

    _, w, h, fmt, qi, *_ = mk.HOST_CASES[case]
    return TheoraInfo(frame_width=w, frame_height=h, pic_width=w,
                      pic_height=h, quality=qi, pixel_fmt=fmt)


def _host_encode(mk, case: str, device="cuda", frames=None):
    """A HOST_CASES case (its frames unless given) through one host
    Encoder on device: (headers + packets, the encoder)."""
    from theora_tpu_torch.encode.encoder import Encoder

    kind, *_, mode, splevel, kf = mk.HOST_CASES[case]
    if frames is None:
        frames = mk.host_frames(kind)
    enc = Encoder(_host_info(mk, case), device=device)
    enc.keyframe_freq = kf
    enc.adaptive_quant = mode
    if splevel:
        enc.set_splevel(splevel)
    pkts = enc.flush_headers() + [
        enc.encode_frame(f, e_o_s=i == len(frames) - 1)
        for i, f in enumerate(frames)]
    return pkts, enc


def _k1_decode_only(what: str) -> int:
    """K1's decode-entry launches since _reset_counts; no other kernel but
    KS (whose entries the caller checks: _ks_decode_only) may have run
    (the host path quantizes and plans natively; at q48 nothing filters).
    """
    c = _counts_all()
    others = {k: v for k, v in c.items() if k not in ("K1 decode", "KS")
              and v}
    if others:
        raise AssertionError(f"{what}: launches {others} besides K1's "
                             f"and KS's decode entries")
    return c["K1 decode"]


def host_encode_720p(smi: str) -> int:
    """12 (a): the host Encoder (encode/encoder.py) on the card, the 16
    720p frames at q48 "auto", a keyframe every 8: the 19 packets against
    hd720_host_q48_k8_enc.sha256 (the JAX host Encoder's), a warm pass
    with the counts reset just before it (K1's decode entry in the closed
    loop only: at most 3 per decoded packet, 14 packets), its wall split
    into ME and mode decision, the closed loop's decode and download, and
    the rest (transform, trellis, packing); PSNR of the port's decode of
    the packets. Returns K1's and KS's launches."""
    from theora_tpu_torch.decode.batch import BatchDecoder
    from theora_tpu_torch.headers import parse_info_header, \
        parse_setup_header

    mk = _load_testdata("make_hd720_enc")
    name = "hd720_host_q48_k8_enc"
    frames = mk.hd_frames()
    pkts, _ = _host_encode(mk, "hd720_q48", frames=frames)
    _check_hashes(pkts, name, "first pass")
    _reset_counts()
    t0 = time.perf_counter()
    pkts, enc = _host_encode(mk, "hd720_q48", frames=frames)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = _k1_decode_only("host encode 720p")
    n = _check_hashes(pkts, name, "warm pass")
    decoded = sum(1 for i in range(len(pkts) - 4) if (i + 1) % mk.HD_KF)
    ks = _ks_decode_only("host encode 720p", 3 * decoded)
    if not 0 < k1 <= 3 * decoded:
        raise AssertionError(f"host encode 720p: K1 {k1} launches; expected "
                             f"1 to {3 * decoded} ({decoded} decoded "
                             f"packets)")
    dec = BatchDecoder(parse_info_header(pkts[0].data),
                       parse_setup_header(pkts[2].data), device="cuda")
    psnr = _psnr(frames, dec.decode_clip([p.data for p in pkts[3:]],
                                         batch=8))
    tm = enc.timing
    rest = tm["frame_s"] - tm["analysis_s"] - tm["decode_s"]
    nf = len(frames)
    log(f"[host720p] host Encoder, q48 'auto', keyframe every {mk.HD_KF}: "
        f"all {n} packet SHA-256 equal the JAX host Encoder's list; warm "
        f"pass {wall:.4f} s = {nf / wall:.2f} frames/s; ME and mode "
        f"decision {tm['analysis_s']:.4f} s, closed-loop decode and "
        f"download {tm['decode_s']:.4f} s ({decoded} packets), transform, "
        f"trellis and packing {rest:.4f} s; K1 decode-entry launches {k1}, "
        f"KS decode-entry launches {ks}, no other kernel; PSNR {psnr:.3f} "
        f"dB; {sum(len(p.data) for p in pkts[3:])} bytes | {smi}")
    return k1, ks


def host_transcode_720p(smi: str) -> int:
    """12 (b): parallel/transcode.py on threads (max_workers=2, one GOP
    each) over the same frames on the card, against the same list.
    Returns K1's and KS's launches."""
    from theora_tpu_torch.parallel.transcode import transcode

    mk = _load_testdata("make_hd720_enc")
    frames = mk.hd_frames()
    info = _host_info(mk, "hd720_q48")
    _reset_counts()
    t0 = time.perf_counter()
    pkts = transcode(frames, info, keyframe_freq=mk.HD_KF, max_workers=2,
                     device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = _k1_decode_only("host transcode 720p")
    # Each GOP's closed loop decodes its frames but the last.
    ks = _ks_decode_only("host transcode 720p",
                         3 * (len(frames) - len(frames) // mk.HD_KF))
    n = _check_hashes(pkts, "hd720_host_q48_k8_enc", "threads")
    log(f"[host transcode720p] transcode(max_workers=2), 2 GOPs on threads: "
        f"all {n} packets equal the sequential list; {wall:.4f} s = "
        f"{len(frames) / wall:.2f} frames/s (first call of the path); K1 "
        f"decode-entry launches {k1}, KS {ks} | {smi}")
    return k1, ks


_DIST_WORKER = r"""
import importlib.util, os, pickle, sys
root, rank, world, port, out = sys.argv[1], int(sys.argv[2]), \
    int(sys.argv[3]), sys.argv[4], sys.argv[5]
sys.path.insert(0, root)
import torch
import torch.distributed as dist
spec = importlib.util.spec_from_file_location(
    "mk", os.path.join(root, "testdata", "make_hd720_enc.py"))
mk = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mk)
from theora_tpu_torch.info import TheoraInfo
from theora_tpu_torch.ops import idct_cuda, loopfilter_cuda, mc_cuda
from theora_tpu_torch.parallel.distributed import distributed_transcode
kind, w, h, fmt, qi, mode, splevel, kf = mk.HOST_CASES["hd720_q48"]
frames = mk.hd_frames()
info = TheoraInfo(frame_width=w, frame_height=h, pic_width=w,
                  pic_height=h, quality=qi, pixel_fmt=fmt)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=world, rank=rank)
pkts = distributed_transcode(frames, info, keyframe_freq=kf, device="cuda")
torch.cuda.synchronize()
dist.barrier()
dist.destroy_process_group()
with open(f"{out}.{rank}", "wb") as f:
    pickle.dump({"k1": idct_cuda.dequantize_idct_frames.launches,
                 "kl": loopfilter_cuda.loop_filter_plane.launches,
                 "ks": [w.launches for w in mc_cuda.ENTRIES],
                 "pkts": [p.data for p in pkts]}, f)
"""


def distributed_720p(smi: str) -> int:
    """12 (c): parallel/distributed.py in two local "gloo" processes, both
    encoding on cuda:0, over the same frames: rank 0's packets against
    the list; each worker reports its K1 count, and the phase sums them.
    Every process it starts is waited for or killed."""
    import pickle
    import socket
    import tempfile

    from theora_tpu_torch.tpkt import Packet

    mk = _load_testdata("make_hd720_enc")
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = str(sk.getsockname()[1])
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        out = os.path.join(tmp, "dist")
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", _DIST_WORKER, ROOT, str(r), "2", port,
             out], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(2)]
        try:
            logs = [p.communicate(timeout=240)[0].decode(errors="replace")
                    for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        if any(p.returncode for p in procs):
            raise AssertionError(f"distributed workers failed: "
                                 f"{[lg[-1500:] for lg in logs]}")
        res = []
        for r in range(2):
            with open(f"{out}.{r}", "rb") as f:
                res.append(pickle.load(f))
    if res[1]["pkts"]:
        raise AssertionError("distributed: rank 1 returned packets")
    n = _check_hashes([Packet(d) for d in res[0]["pkts"]],
                      "hd720_host_q48_k8_enc", "distributed")
    k1 = [r["k1"] for r in res]
    if not all(k1) or any(r["kl"] for r in res):
        raise AssertionError(f"distributed: K1 launches per rank {k1}, KL "
                             f"{[r['kl'] for r in res]} (q48: none)")
    # KS's decode entry in each rank's closed loop: 3 per decoded frame,
    # each GOP's frames but the last; no encode-side entry.
    ks = [r["ks"][-1] for r in res]
    if any(sum(r["ks"][:-1]) for r in res) or sum(ks) != 3 * (
            len(mk.hd_frames()) - len(mk.hd_frames()) // mk.HD_KF):
        raise AssertionError(f"distributed: KS launches per rank "
                             f"{[r['ks'] for r in res]}")
    log(f"[distributed720p] 2 gloo processes on one card: all {n} packets "
        f"of rank 0 equal the sequential list; K1 decode-entry launches "
        f"per rank {k1}, sum {sum(k1)}; KS decode-entry launches per rank "
        f"{ks}; {wall:.2f} s with the processes' start | {smi}")
    return sum(k1), sum(ks)


@contextlib.contextmanager
def _decoded_frames():
    """Every packet that a PacketDecoder (the host Encoder's closed loop,
    th_dec_ctx, the legacy decoder) decodes to a new frame while the
    block runs: yields a list that gets, per such packet, whether its
    frame filters (its qi's loop-filter limit is above 0)."""
    from theora_tpu_torch.decode.scalar import PacketDecoder

    out = []
    real = PacketDecoder.decode_packet

    def recorded(self, packet):
        ret = real(self, packet)
        if ret == 0:
            lim = self.setup.qinfo["loop_filter_limits"][packet[0] & 0x3F]
            out.append(lim > 0)
        return ret

    PacketDecoder.decode_packet = recorded
    try:
        yield out
    finally:
        PacketDecoder.decode_packet = real


def _closed_loop_counts(what: str, decoded: list) -> tuple:
    """(K1's decode entry, KL, KS's mc_recon) since _reset_counts, for the
    frames `decoded` recorded (_decoded_frames): K1 1 to 3 per frame, KL
    3 per frame that filters, mc_recon 3 per frame, and no other kernel
    (the host tier quantizes, plans and searches natively; no pp level)."""
    c = _counts_all()
    n, nf = len(decoded), sum(decoded)
    others = {k: v for k, v in c.items()
              if k not in ("K1 decode", "KL", "KS") and v}
    ks = _ks_decode_only(what, 3 * n)
    if others or not 0 < c["K1 decode"] <= 3 * n or c["KL"] != 3 * nf:
        raise AssertionError(f"{what}: launches {c}; expected K1's decode "
                             f"entry 1 to {3 * n}, KL {3 * nf} and KS "
                             f"{3 * n} ({n} decoded frames, {nf} "
                             f"filtered) and nothing else")
    return c["K1 decode"], c["KL"], ks


def compat_cbr_720p(smi: str) -> tuple:
    """12 (d), the slice's main path: th_enc_ctx (compat.py) on the card
    under a target bitrate, the 16 720p frames, a keyframe every 8, info
    quality 0, 300 kbit/s (make_compat_enc.run_hd720): a first pass, then
    a warm pass with the counts reset just before it; every packet
    against hd720_compat_cbr_enc.sha256 (the JAX th_enc_ctx's), the
    dropped frames (0-byte packets) counted, at least one; the closed
    loop's launches (K1's decode entry, KL, KS's mc_recon), KL above 0;
    the wall split. Returns (K1, KL, KS)."""
    from theora_tpu_torch import compat
    from theora_tpu_torch.info import TheoraInfo

    mc = _load_testdata("make_compat_enc")
    name = "hd720_compat_cbr_enc"
    frames = mc.mk.hd_frames()
    pkts, _ = mc.run_hd720(compat, TheoraInfo, frames, device="cuda")
    _check_hashes(pkts, name, "first pass")
    with _decoded_frames() as decoded:
        _reset_counts()
        t0 = time.perf_counter()
        pkts, ctx = mc.run_hd720(compat, TheoraInfo, frames, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = _check_hashes(pkts, name, "warm pass")
    k1, kl, ks = _closed_loop_counts("th_enc_ctx 720p CBR", decoded)
    drops = [i for i, p in enumerate(pkts[3:]) if not p.data]
    rc = ctx._enc.rc
    if not drops or rc.ndrops != len(drops) or kl == 0:
        raise AssertionError(f"th_enc_ctx 720p CBR: dropped frames {drops}, "
                             f"the controller's {rc.ndrops}, KL {kl}; "
                             f"expected a drop and KL above 0")
    qis = sorted({p.data[0] & 0x3F for p in pkts[3:] if p.data})
    tm = ctx._enc.timing
    rest = tm["frame_s"] - tm["analysis_s"] - tm["decode_s"]
    nbytes = sum(len(p.data) for p in pkts[3:])
    log(f"[compat720p] th_enc_ctx(device='cuda') at {mc.HD_CBR_RATE} bit/s, "
        f"keyframe every {mc.HD_KF}: all {n} packet SHA-256 equal the JAX "
        f"th_enc_ctx's list; dropped frames {drops} (0-byte packets), qis "
        f"{qis}, {nbytes} bytes = {nbytes * 8 * 30 / len(frames):.0f} "
        f"bit/s; warm pass {wall:.4f} s = {len(frames) / wall:.2f} "
        f"frames/s: ME and mode decision {tm['analysis_s']:.4f} s, "
        f"closed-loop decode and download {tm['decode_s']:.4f} s "
        f"({len(decoded)} frames decoded, {sum(decoded)} filtered), "
        f"transform, trellis and packing {rest:.4f} s; launches K1 decode "
        f"entry {k1}, KL {kl}, KS mc_recon {ks}, no other kernel | {smi}")
    return k1, kl, ks


def compat_small() -> tuple:
    """12 (e): every case of make_compat_enc.CASES (th_enc_ctx at VBR,
    CBR with drops, drops off with mid-stream bitrate and buffer changes,
    VP3 with its drop frames, VP31 quantization parameters, other Huffman
    codes, another encoder's setup header, the dup count, the 2-pass ctl
    protocol, the legacy theora_* round trip) with device="cuda" against
    compat64x48_enc.sha256 (the JAX package's); the VP3 stream decoded by
    PacketDecoder(device="cuda") equal to the plain path's
    (device="cpu") frame by frame, drop frames included. Returns (K1, KL,
    KS) of the cases' closed loops and decoders."""
    from theora_tpu_torch import compat, tables
    from theora_tpu_torch.decode.scalar import PacketDecoder
    from theora_tpu_torch.headers import parse_info_header, \
        parse_setup_header
    from theora_tpu_torch.info import TheoraInfo
    from theora_tpu_torch.tpkt import Packet

    mc = _load_testdata("make_compat_enc")
    want = mc.mk.read_records("compat64x48_enc.sha256")
    got = {}
    with _decoded_frames() as decoded:
        _reset_counts()
        for name in mc.CASES:
            got[name] = mc.run_case(name, compat, tables, TheoraInfo,
                                    Packet, device="cuda")
        torch.cuda.synchronize()
    counts = _closed_loop_counts("compat 64x48", decoded)
    bad = [name for name in mc.CASES
           if mc.mk.record_of(got[name]) != want[name]]
    if bad:
        raise AssertionError(f"compat64x48_enc: cases {bad} differ from the "
                             f"JAX package's")
    vp3 = [p.data for p in got["vp3_8k"]]
    info, setup = parse_info_header(vp3[0]), parse_setup_header(vp3[2])
    card_dec = PacketDecoder(info, setup, device="cuda")
    plain = PacketDecoder(info, setup, device="cpu")
    for i, d in enumerate(vp3[3:]):
        if card_dec.decode_packet(d) != plain.decode_packet(d) or not all(
                np.array_equal(a, b) for a, b in zip(card_dec.ycbcr_out(),
                                                     plain.ycbcr_out())):
            raise AssertionError(f"vp3_8k: frame {i} of the card's decode "
                                 f"differs from the plain path's")
    ndrop = sum(len(d) == 6 for d in vp3[3:])
    log(f"[compat64x48_enc] {len(mc.CASES)} cases {list(mc.CASES)}: all "
        f"{sum(map(len, got.values()))} records (the packets and the 2-pass "
        f"blob) equal the JAX package's; the VP3 stream's {len(vp3) - 3} "
        f"frames ({ndrop} drop frames) decode on the card as on the plain path; "
        f"launches K1 decode entry {counts[0]}, KL {counts[1]}, KS mc_recon "
        f"{counts[2]} ({len(decoded)} frames decoded)")
    return counts


def enc_cli_host(smi: str) -> tuple:
    """12 (f): `tools.enc --host` (the host Encoder, its closed loop on
    the card) on the 64x48 clip cut to 60x44, for each make_compat_enc.
    CLI_CASES case (-b with drops, --drop-frames 0, --two-pass
    --rate-buffer 12): the .ogv against compat_cli.sha256 (the JAX CLI's
    default branch). Returns (K1, KL, KS) of the three runs."""
    import tempfile

    from theora_tpu_torch.tools import enc
    from theora_tpu_torch.tools.y4m import write_y4m

    mc = _load_testdata("make_compat_enc")
    want = mc.mk.read_cli("compat_cli.sha256")
    walls = {}
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp, \
            _decoded_frames() as decoded:
        src = os.path.join(tmp, "in.y4m")
        write_y4m(src, mc.cli_frames())
        _reset_counts()
        for case, flags in mc.CLI_CASES.items():
            out = os.path.join(tmp, f"{case}.ogv")
            t0 = time.perf_counter()
            enc.main(["--host", *flags, src, out])
            walls[case] = round(time.perf_counter() - t0, 4)
            with open(out, "rb") as f:
                if hashlib.sha256(f.read()).hexdigest() != want[case]:
                    raise AssertionError(f"enc --host {case}: the .ogv "
                                         f"differs from the JAX CLI's")
        torch.cuda.synchronize()
    counts = _closed_loop_counts("enc --host", decoded)
    log(f"[enc --host] {list(mc.CLI_CASES)}: every .ogv equals the JAX "
        f"CLI's (compat_cli.sha256); walls {walls} s; launches K1 decode "
        f"entry {counts[0]}, KL {counts[1]}, KS mc_recon {counts[2]} | "
        f"{smi}")
    return counts


def host_small() -> None:
    """12 (g): every 64x48 and 96x64 HOST_CASES case through the host
    Encoder on the card against host64x48_enc and host96x64_aq_enc (q40
    filters in the closed loop on the card)."""
    mk = _load_testdata("make_hd720_enc")
    for name, cases in (("host64x48_enc", mk.HOST_SMALL),
                        ("host96x64_aq_enc", mk.HOST_AQ)):
        n = _check_hashes([p for c in cases for p in _host_encode(mk, c)[0]],
                          name, "cases")
        log(f"[{name}] cases {list(cases)}: all {n} packets equal the JAX "
            f"host Encoder's (SHA-256)")


def enc_cli_workers(smi: str) -> None:
    """12 (h): `python -m theora_tpu_torch.tools.enc -j 2` on the card:
    transcode over two spawned processes, each encoding on the card, of
    the 64x48 clip at q40, a keyframe every 4 (HOST_CASES "q40"); the
    Ogg stream's packets against the case's lines of host64x48_enc."""
    import tempfile

    from theora_tpu_torch.ogg import demux_stream
    from theora_tpu_torch.tools.y4m import write_y4m

    mk = _load_testdata("make_hd720_enc")
    kind, _, _, _, qi, _, _, kf = mk.HOST_CASES["q40"]
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        src, out = os.path.join(tmp, "in.y4m"), os.path.join(tmp, "out.ogv")
        write_y4m(src, mk.host_frames(kind))
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "theora_tpu_torch.tools.enc", "-j", "2",
             "-q", str(qi), "-k", str(kf), src, out], cwd=ROOT,
            capture_output=True, text=True, timeout=240)
        wall = time.perf_counter() - t0
        if r.returncode != 0:
            raise AssertionError(f"enc -j 2 failed: {r.stderr[-1500:]}")
        with open(out, "rb") as f:
            pkts = demux_stream(f.read())
    with open(os.path.join(TESTDATA, "host64x48_enc.sha256")) as f:
        want = f.read().split()[:len(pkts)]
    if len(pkts) != 3 + len(mk.host_frames(kind)) or \
            _packet_hashes(pkts) != want:
        raise AssertionError("enc -j 2: packets differ from host64x48_enc")
    log(f"[enc -j 2] 64x48 q{qi}, keyframe every {kf}, two spawned "
        f"processes on the card: all {len(pkts)} packets equal the list; "
        f"{wall:.2f} s with the processes' start ({r.stderr.strip()}) | "
        f"{smi}")

# ------------------------------------------------ kernel KP: postprocessing

def _kp_launches() -> int:
    from theora_tpu_torch.ops import postproc_cuda

    return (postproc_cuda.postprocess_plane.launches
            + postproc_cuda.postprocess_frames.launches)


def kp_vs_plain(device, smi: str) -> dict:
    """6g: KP (the decoder's postprocessor, ops/postproc_cuda.py,
    csrc/postproc.cu) against its plain version (ops/postproc.py:
    postprocess_plane, on the same inputs on the CPU) byte for byte:
    postprocess_plane on tools/bench_pp.py:cases (random 720p luma, 4:2:0,
    4:2:2 and 4:4:4 chroma planes at every pp level's plane and strength
    choice, one-row and one-column planes, variances on each dering
    threshold and one either side) and on the long-chain frame: frame 0
    of the JAX package's 720p benchmark clip (bench_pp.gen_frames, a copy
    of bench.py:gen_frames) encoded on the card by GopEncoder at qi 5 as a
    keyframe and decoded by PacketDecoder(device="cuda"), whose pp 7
    output must equal the plain version on its pp 0 planes; and
    postprocess_frames on bench_pp.frame_cases (F = 1, 3 and 8, dering
    off, on and strong mixed, a frame without pp in the middle, padded
    planes' views, 4:2:0, 4:2:2 and 4:4:4 chroma; rows that wait on a
    filtered block above, counted). CUDA-event times in turns with KP's
    earlier design (tools/kp_block_serial.cu, built from the checkout) at
    the keyframe's and the raw frame's (bench_pp.frame_calls) luma and
    4:2:0 chroma (the deblock launch, the dering launch, both; the plain
    version, one call; a device copy of the plane; the call's empty
    launches) beside the bound (bench_pp.kp_bound, the chain at
    bench_pp.measure_step_ns), and an 8-frame luma batch of raw frames
    (bench_pp.time_batch) beside bench_pp.kp_bound_batch."""
    from theora_tpu_torch.decode.scalar import PacketDecoder
    from theora_tpu_torch.headers import parse_info_header, \
        parse_setup_header
    from theora_tpu_torch.tools import bench_pp as bp

    t0 = time.perf_counter()
    y, u, v = bp.gen_frames(1)[0]
    pkts = _encoder(1280, 720, 0, 5, False).encode_clip([[y, u, v]],
                                                        keyframe_freq=1)
    info = parse_info_header(pkts[0].data)
    setup = parse_setup_header(pkts[2].data)
    outs = {}
    for level in (0, 7):
        dec = PacketDecoder(info, setup, device="cuda")
        dec.set_pplevel(level)
        if dec.decode_packet(pkts[3].data) != 0:
            raise AssertionError("the qi-5 keyframe did not decode")
        outs[level] = dec.ycbcr_out()
    if dec.qis != [5]:
        raise AssertionError(f"the keyframe's qis {dec.qis}, expected [5]")
    tabs = (dec._pp_dc_scale, dec._pp_sharp_mod)
    long_cases = []
    for pli, label in enumerate(("luma", "Cb", "Cr")):
        plane = np.ascontiguousarray(outs[0][pli][::-1])
        q = np.full((plane.shape[0] >> 3, plane.shape[1] >> 3), 5)
        args = bp._args(plane, q, q, tabs, True, True, pli, device)
        long_cases.append((f"long-chain frame {label}", args))
    frame_cases = bp.frame_cases(device)
    todo = bp.cases(device) + frame_cases + long_cases
    wants = bp.plain_all([a for _, a in todo])
    for pli, want in enumerate(wants[-3:]):
        if not np.array_equal(outs[7][pli][::-1], want.numpy()):
            raise AssertionError(f"PacketDecoder at pp 7, plane {pli}: != "
                                 f"the plain version on its pp 0 planes")
    n, err = bp.check(device, todo, wants)
    waits = {label: bp.north_waits(c) for label, c in frame_cases}
    if not all(waits[label] for label, c in frame_cases
               if any(c["dering"])):
        raise AssertionError(f"a frame case derings no block under a "
                             f"filtered one: {waits}")
    log(f"[kp] {n} cases: kernels == plain (deblock, then dering) byte for "
        f"byte: {n - len(frame_cases)} postprocess_plane calls, contiguous "
        f"and into a padded plane's strided image, one launch each for the "
        f"deblock and the dering; {len(frame_cases)} postprocess_frames "
        f"batches into a strided [F, h, w] output, one deblock and one "
        f"dering launch each, the frames without pp untouched; inputs "
        f"untouched; max |err| {err} (tolerance 0: exact); filtered blocks "
        f"under a filtered block (where rows wait) per batch {waits}")
    log("[kp] long-chain frame (1280x720 keyframe at qi 5, GopEncoder on "
        "the card): PacketDecoder pp 7 == plain on its pp 0 planes")
    step = bp.measure_step_ns(device)
    if not 0.1 < step < 1000:
        raise AssertionError(f"KP step probe: {step} ns per update")
    log(f"[kp] one dering pixel update on the chain (th_pp_step_probe): "
        f"{step:.3f} ns | {smi}")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    parent = bp.parent_kernel()
    raw = bp.gen_frames(8)
    raw_calls = bp.frame_calls(raw[0], device)
    rows = {}
    for label, args in (("keyframe 720p luma", long_cases[0][1]),
                        ("keyframe 720p 4:2:0 chroma", long_cases[1][1]),
                        ("raw frame 720p luma", raw_calls["720p luma"]),
                        ("raw frame 720p 4:2:0 chroma",
                         raw_calls["720p 4:2:0 chroma"])):
        rows[label] = bp.time_call(args, flush, step, parent)
        log(f"[kp] time, {bp.describe(label, rows[label])} | {smi}")
    batch = bp.time_batch([bp.frame_calls(f, device)["720p luma"]
                           for f in raw], flush, step, parent)
    log(f"[kp] time, {bp.describe_batch('raw frames, 720p luma', batch)} | "
        f"{smi}")
    log(f"[kp] phase 6g took {time.perf_counter() - t0:.1f} s")
    one = rows["keyframe 720p luma"]
    keys = ("ms", "parent_ms", "deblock_ms", "parent_deblock_ms",
            "dering_ms", "parent_dering_ms", "turns", "deblock_turns",
            "dering_turns", "plain_ms", "copy_ms", "empty_ms", "bound_ms",
            "bound_by", "bytes", "bytes_ms", "chain_steps", "step_ns",
            "chain_ms", "launch_bytes", "wavefront")
    return {
        "name": "postprocess", "route": "cuda",
        "source": "theora_tpu_torch/csrc/postproc.cu",
        "replaces": "theora_tpu/ops/postproc_np.py:273",
        "launches": None, "max_abs_err": err, "ms": one["ms"],
        "plain_ms": one["plain_ms"], "bound_ms": one["bound_ms"],
        "bound_by": one["bound_by"], "library_ms": None,
        "timed": "720p luma plane of the qi-5 keyframe at pp 7: the "
                 "deblock and the dering launch",
        "copy_ms": one["copy_ms"], "parent_ms": one["parent_ms"],
        "shapes": {label: {k: r[k] for k in keys if k in r}
                   for label, r in rows.items()},
        "batch_8_luma": batch,
    }


def pp_goldens() -> int:
    """The pp 2 and pp 7 goldens: clip64x48_k8_q5 through
    PacketDecoder(device="cuda") and decode_clip at each level against
    libtheora's .pp2.yuv / .pp7.yuv byte for byte, KP launched once (level
    2: the luma deblock) or six times (level 7: deblock and dering of each
    plane) per batch of 8 by decode_clip and per frame by PacketDecoder.
    Returns KP's launches."""
    from theora_tpu_torch.decode.scalar import PacketDecoder

    t0 = time.perf_counter()
    total = 0
    for level, per_frame in ((2, 1), (7, 6)):
        bd, data = _open("clip64x48_k8_q5.tpkt")
        ref = np.fromfile(os.path.join(
            TESTDATA, f"clip64x48_k8_q5.pp{level}.yuv"),
            np.uint8).reshape(len(data), -1)
        before = _kp_launches()
        bd.set_pplevel(level)
        got = [_frame_bytes(o) for o in bd.decode_clip(data, batch=8)]
        kp_batch = _kp_launches() - before
        pd = PacketDecoder(bd.info, bd.setup, device="cuda")
        pd.set_pplevel(level)
        for d in data:
            pd.decode_packet(d)
            got.append(_frame_bytes(pd.ycbcr_out()))
        kp = _kp_launches() - before
        bad = [i for i, g in enumerate(got)
               if g != ref[i % len(data)].tobytes()]
        if bad:
            raise AssertionError(f"pp {level}: frames {bad} differ from "
                                 f"the golden (decode_clip, then per packet)")
        batches = -(-len(data) // 8)
        if kp_batch != per_frame * batches \
                or kp != per_frame * (batches + len(data)):
            raise AssertionError(f"pp {level}: KP launches {kp_batch} by "
                                 f"batch, {kp - kp_batch} per packet")
        total += kp
        log(f"[pp golden] clip64x48_k8_q5 pp {level}: decode_clip and "
            f"PacketDecoder, {len(data)} frames each, byte-identical to "
            f".pp{level}.yuv; KP launches {kp_batch} by batch ({batches} "
            f"batches), {kp - kp_batch} per packet")
    log(f"[pp golden] took {time.perf_counter() - t0:.1f} s")
    return total


def real_size_pp7(smi: str) -> dict:
    """The 720p stream at pp 7 (the slice's main path): decode_clip(batch=
    8) and PacketDecoder, every frame's SHA-256 against
    testdata/hd720_q56_k12_pp7.sha256 (the JAX host Decoder's at level 7,
    testdata/make_hd720.py pp7); warm passes with the counts reset just
    before each: decode_clip at pp 7 and at pp 0 in turns (pp 0, 7, 7, 0),
    KP's launches (two per plane per batch of 8 at pp 7, none at pp 0;
    K1, KS and KL as at pp 0; per packet two per plane per frame), walls, host parse and device busy time (CUDA
    events around each batch's device work); one pass under torch.profiler
    for KP's share of the device time. Returns KP's launches by path."""
    from torch.profiler import ProfilerActivity, profile

    from theora_tpu_torch.decode.scalar import PacketDecoder
    from theora_tpu_torch.tools.profile_decode import _split

    t_phase = time.perf_counter()
    with open(os.path.join(TESTDATA, f"{HD_NAME}_pp7.sha256")) as f:
        want = f.read().split()

    def check(outs, what):
        got = [hashlib.sha256(_frame_bytes(o)).hexdigest() for o in outs]
        if got != want:
            bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
            raise AssertionError(f"{HD_NAME} pp 7 {what}: frames {bad} "
                                 f"differ")

    def clip(level):
        dec, data = _open(f"{HD_NAME}.ogv")
        dec.set_pplevel(level)
        dec.device_spans = []
        _reset_counts()
        t0 = time.perf_counter()
        outs = dec.decode_clip(data, batch=8)
        wall = time.perf_counter() - t0
        counts = _counts_all()
        torch.cuda.synchronize()
        busy = sum(a.elapsed_time(b) for a, b in dec.device_spans) / 1e3
        return outs, {"wall_s": wall, "host_parse_s": dec.host_parse_s,
                      "device_busy_s": busy, "launches": counts}

    outs, _ = clip(7)
    check(outs, "decode_clip, first pass")
    nf = len(want)
    runs = {0: [], 7: []}
    for level in (0, 7, 7, 0):
        outs, r = clip(level)
        if level:
            check(outs, "decode_clip, warm pass")
        runs[level].append(r)
    base = {k: v for k, v in runs[0][0]["launches"].items()}
    for level, rs in runs.items():
        for r in rs:
            c = dict(r["launches"])
            kp = c.pop("KP")
            if kp != (6 * -(-nf // 8) if level else 0) or c != {
                    k: v for k, v in base.items() if k != "KP"}:
                raise AssertionError(f"pp {level} launches {r['launches']}"
                                     f" (pp 0: {base})")
    dec, data = _open(f"{HD_NAME}.ogv")
    pd = PacketDecoder(dec.info, dec.setup, device="cuda")
    pd.set_pplevel(7)
    _reset_counts()
    t0 = time.perf_counter()
    pouts = []
    for d in data:
        pd.decode_packet(d)
        pouts.append(pd.ycbcr_out())
    pwall = time.perf_counter() - t0
    pcounts = _counts_all()
    check(pouts, "per packet")
    if pcounts["KP"] != 6 * nf:
        raise AssertionError(f"per-packet pp 7 launches {pcounts}")
    dec.set_pplevel(7)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dec.decode_clip(data, batch=8)
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0
    _, kernels = _split(prof.events())
    busy = sum(sec for sec, _ in kernels.values())
    kp_s = {k: v for k, v in kernels.items() if "th_pp_" in k}
    kp_sum = sum(sec for sec, _ in kp_s.values())
    if not kp_s:
        raise AssertionError("the traced pp 7 pass shows no KP kernel")

    def mean(rs, key):
        return sum(r[key] for r in rs) / len(rs)

    log(f"[720p pp7] {nf} frames at pp 7, all SHA-256 equal the JAX host "
        f"Decoder's (decode_clip and PacketDecoder); warm decode_clip "
        f"walls pp 7 {[r['wall_s'] for r in runs[7]]} s against pp 0 "
        f"{[r['wall_s'] for r in runs[0]]} s (in turns 0, 7, 7, 0); host "
        f"parse pp 7 {mean(runs[7], 'host_parse_s'):.4f} s, pp 0 "
        f"{mean(runs[0], 'host_parse_s'):.4f} s; device busy (CUDA events "
        f"per batch) pp 7 {mean(runs[7], 'device_busy_s'):.4f} s, pp 0 "
        f"{mean(runs[0], 'device_busy_s'):.4f} s; KP launches "
        f"{runs[7][0]['launches']['KP']} = "
        f"{runs[7][0]['launches']['KP'] / (3 * -(-nf // 8)):.0f} per plane "
        f"per batch of 8, the other kernels' as at pp 0 {base}; per "
        f"packet {pwall:.4f} s = {1e3 * pwall / nf:.3f} ms per frame, KP "
        f"{pcounts['KP']} | {smi}")
    log(f"[720p pp7] traced decode_clip pass: wall {traced_wall:.4f} s, "
        f"device kernels {busy:.6f} s, KP {kp_sum:.6f} s = "
        f"{100 * kp_sum / busy:.1f}% of it "
        f"({ {k[:40]: (round(v[0], 6), v[1]) for k, v in kp_s.items()} }) "
        f"| {smi}")
    log(f"[720p pp7] took {time.perf_counter() - t_phase:.1f} s")
    return {"decode pp7": runs[7][0]["launches"]["KP"],
            "decode per packet pp7": pcounts["KP"],
            "pp7 traced KP s": kp_sum,
            "pp7 warm walls_s": {str(k): [r["wall_s"] for r in rs]
                                 for k, rs in runs.items()},
            "pp7 traced share": kp_sum / busy}



# ---------------------------------------------------------------------------
# 13. The tools on the card.
SWEEP_720P = ["--size", "1280x720", "--frames", "16", "--qis", "24,48",
              "--content", "smooth,textured", "--skip", "ref"]
TOOLS_COUNTS = {}


def _tool_counts(what: str, must: tuple, never: tuple = ()) -> dict:
    """The launches since _reset_counts of every kernel, kept under
    TOOLS_COUNTS[what]: each kernel of `must` launched, none of `never`."""
    c = _counts_all()
    missing = [k for k in must if not c[k]]
    extra = {k: c[k] for k in never if c[k]}
    if missing or extra:
        raise AssertionError(f"{what}: launches {c}; expected launches of "
                             f"{missing} and none of {extra}")
    TOOLS_COUNTS[what] = c
    return c


def _listed_blocks(name: str, n: int) -> list:
    with open(os.path.join(TESTDATA, name)) as f:
        lines = f.read().split()
    return [lines[i:i + n] for i in range(0, len(lines), n)]


def tools_sweep(smi: str) -> None:
    """13 (a), the slice's main path: `qualitysweep --size 1280x720
    --frames 16 --qis 24,48 --content smooth,textured --skip ref` on the
    card, counts reset just before it. Every host-column stream against
    sweep720_host.sha256 and every device-column stream against
    sweep720_dev.sha256 (the JAX tool's encoders'); each stream decoded by
    BatchDecoder(device="cuda").decode_clip equal to the sweep's
    PacketDecoder frames; every row's PSNR and SSIM against the same
    metric recomputed on the card (equal) and on the CPU (to 1e-9: the
    clip's PSNR, and one frame's SSIM per stream); the walls."""
    from theora_tpu_torch import metrics
    from theora_tpu_torch.decode.batch import BatchDecoder
    from theora_tpu_torch.headers import parse_info_header, \
        parse_setup_header
    from theora_tpu_torch.tools import qualitysweep as qs

    keep = {}
    _reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        rows = qs.main([*SWEEP_720P, "--device", "cuda"], keep=keep)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = _tool_counts("qualitysweep 720p",
                     ("K1 decode", "K1 encode", "K2", "KT", "KM", "KL",
                      "KS"), ("KR", "KP"))
    lists = {"host": _listed_blocks("sweep720_host.sha256", 19),
             "dev": _listed_blocks("sweep720_dev.sha256", 19)}
    order = [(r["content"], r["qi"]) for r in rows]
    worst = 0.0
    for i, (kind, qi) in enumerate(order):
        src = qs.gen_content(kind, 16)
        for col in ("host", "dev"):
            pkts, rec = keep[(kind, qi, col)]
            if _packet_hashes(pkts) != lists[col][i]:
                raise AssertionError(f"qualitysweep {kind} q{qi} {col}: "
                                     f"packets differ from the JAX list")
            dec = BatchDecoder(parse_info_header(pkts[0].data),
                               parse_setup_header(pkts[2].data), "cuda")
            frames = dec.decode_clip([p.data for p in pkts[3:]], batch=8)
            for a, b in zip(frames, rec):
                if any(not np.array_equal(x, y) for x, y in zip(a, b)):
                    raise AssertionError(f"qualitysweep {kind} q{qi} {col}:"
                                         f" the two decoders differ")
            dev_psnr = qs.luma_psnr(src, rec, "cuda")
            dev_ssim = qs.luma_ssim(src, rec, "cuda")
            r = rows[i]
            if (dev_psnr, dev_ssim) != (r[f"{col}_psnr"], r[f"{col}_ssim"]):
                raise AssertionError(f"qualitysweep {kind} q{qi} {col}: the "
                                     f"card's metrics are not repeatable")
            cpu_psnr = metrics.clip_luma_psnr(src, rec)
            last = len(rec) - 1
            card_ssim = metrics.ssim(
                torch.as_tensor(src[last][0]).cuda(),
                torch.as_tensor(rec[last][0]).cuda())
            cpu_ssim = metrics.ssim(src[last][0], rec[last][0])
            for a, b in ((dev_psnr, cpu_psnr), (card_ssim, cpu_ssim)):
                err = abs(a - b) / abs(b)
                worst = max(worst, err)
                if err > 1e-9:
                    raise AssertionError(f"qualitysweep {kind} q{qi} {col}:"
                                         f" card {a!r} vs CPU {b!r}")
            log(f"[13a] {kind} q{qi} {col}: {r[f'{col}_bytes']} bytes, "
                f"{dev_psnr:.4f} dB, SSIM {dev_ssim:.5f}, encode wall "
                f"{keep[(kind, qi, col, 's')]:.4f} s; packets equal the "
                f"JAX list; BatchDecoder == PacketDecoder | {smi}")
    log(f"[13a] qualitysweep 1280x720 16 frames x 2 contents x 2 qis, host "
        f"and device columns: wall {wall:.4f} s (host encodes "
        f"{sum(v for k, v in keep.items() if k[2:] == ('host', 's')):.4f}"
        f" s, device encodes "
        f"{sum(v for k, v in keep.items() if k[2:] == ('dev', 's')):.4f} "
        f"s); card vs CPU metrics worst relative error {worst:.3g}; "
        f"launches {c} | {smi}")


def _damaged(stream):
    """A fuzz stream with packets the host parse rejects (a header bit
    set, all ones) and ones it takes (all zeros, one byte)."""
    from theora_tpu_torch.tpkt import Packet

    pk = stream.packets
    bad = [b"\x80" + pk[4].data[1:], b"\xff" * 30, bytes(30), pk[4].data[:1]]
    stream.packets = pk[:4] + [Packet(d, granulepos=1) for d in bad] + pk[4:]
    stream.desc += " +damaged"
    return stream


def tools_crosscheck(smi: str) -> dict:
    """13 (b): crosscheck's --gop, --fuzz and --synth trials (seed 24, 6
    each, up to 96x80; the streams built on the card) and a fuzz stream
    with damaged packets: PacketDecoder(device="cuda") against
    PacketDecoder(device="cpu") (the kernels' plain versions), the same
    per-packet statuses and bytes; the card decodes' launches of KP, KL
    and KS's mc_recon, each above 0."""
    from theora_tpu_torch.tools import crosscheck as cc

    t0 = time.perf_counter()
    total = dict.fromkeys(_counts_all(), 0)
    statuses = {"ok": 0, "dup": 0, "bad": 0}
    n = 0
    for direction in ("gop", "fuzz", "synth"):
        rng = np.random.RandomState(24)
        for t in range(7 if direction == "fuzz" else 6):
            stream = cc.BUILDERS[direction](rng, t, "cuda")
            if t == 6:
                stream = _damaged(stream)
            _reset_counts()
            card = cc.decode_port(stream, "cuda")
            torch.cuda.synchronize()
            for k, v in _counts_all().items():
                total[k] += v
            _reset_counts()
            plain = cc.decode_port(stream, "cpu")
            if any(_counts_all().values()):
                raise AssertionError(f"crosscheck {stream.desc}: the CPU "
                                     f"decode launched {_counts_all()}")
            err = cc.compare(stream, plain, card)
            if card[0] != plain[0] or err:
                raise AssertionError(f"crosscheck {stream.desc}: card "
                                     f"{card[0]} vs plain {plain[0]}: {err}")
            for s in card[0]:
                statuses[s] += 1
            n += 1
    if not (total["KP"] and total["KL"] and total["KS"] and statuses["bad"]):
        raise AssertionError(f"crosscheck: launches {total}, statuses "
                             f"{statuses}; expected KP, KL, mc_recon and a "
                             f"rejected packet")
    TOOLS_COUNTS["crosscheck decodes"] = total
    log(f"[13b] crosscheck --gop/--fuzz/--synth: {n} streams, statuses "
        f"{statuses}, card == plain for every packet; the card decodes' "
        f"launches KP {total['KP']}, KL {total['KL']}, KS mc_recon "
        f"{total['KS']}, K1 decode {total['K1 decode']}; "
        f"{time.perf_counter() - t0:.1f} s | {smi}")
    return total


def tools_collect(smi: str) -> None:
    """13 (c): collect's gather with mode_rd on the first 8 frames of the
    720p source at qi 24 and 48 on the card: every packet and every
    frame's rows against collect720_moderd.sha256 (the JAX host
    Encoder's); the closed loop's launches."""
    import tempfile

    from theora_tpu_torch.tools import collect

    mk = _load_testdata("make_tools")
    want = mk.read_collect()
    frames = mk.hd_source()[:mk.COLLECT_FRAMES]
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "src.i420")
        with open(path, "wb") as f:
            for fr in frames:
                for p in fr:
                    f.write(np.ascontiguousarray(p).tobytes())
        record = []
        _reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            rows = collect.gather([(path, 1280, 720)], list(want),
                                  kf=mk.COLLECT_KF,
                                  max_frames=mk.COLLECT_FRAMES, mode_rd=True,
                                  device="cuda", record=record)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    c = _tool_counts("collect mode_rd 720p", ("K1 decode", "KS"),
                     ("K1 encode", "K2", "KT", "KR", "KM", "KP"))
    for (qi, (pk_want, rows_want)), (pkts, per_frame) in zip(want.items(),
                                                              record):
        got = [mk.rows_hash(r) for r in per_frame]
        if _packet_hashes(pkts) != pk_want or got != rows_want:
            raise AssertionError(f"collect q{qi}: packets or rows differ "
                                 f"from the JAX list")
    log(f"[13c] collect --mode-rd 1280x720 8 frames at qi {list(want)}: "
        f"{len(rows)} rows, every packet and every frame's rows equal the "
        f"JAX list; wall {wall:.4f} s; launches {c} | {smi}")


def tools_profile(smi: str) -> None:
    """13 (d): profile --mode encode and --mode decode on the card: each
    trace file exists and carries the codec's record_function labels."""
    import tempfile

    from theora_tpu_torch.tools import profile

    labels = {"encode": ("theora.enc.me", "theora.enc.fdct_quant",
                         "theora.enc.trellis", "theora.enc.idct_recon"),
              "decode": ("theora.dequant_idct", "theora.mc_recon")}
    with tempfile.TemporaryDirectory() as td:
        for mode, want in labels.items():
            out = os.path.join(td, mode)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(sys.stderr):
                profile.main(["--mode", mode, "--out", out, "--device",
                              "cuda"])
            with open(os.path.join(out, "trace.json")) as f:
                events = json.load(f)["traceEvents"]
            names = {e.get("name") for e in events}
            kernels = sum(e.get("cat") == "kernel" for e in events)
            missing = [x for x in want if x not in names]
            if missing:
                raise AssertionError(f"profile {mode}: labels {missing} "
                                     f"missing from the trace")
            log(f"[13d] profile --mode {mode}: trace.json with "
                f"{len(events)} events, labels {list(want)} present, "
                f"{kernels} device kernel events; "
                f"{time.perf_counter() - t0:.1f} s | {smi}")


def tools_play(smi: str) -> None:
    """13 (e): play --stats-only -o on the 720p test stream: the y4m's
    frames against hd720_q56_k12.sha256; its launches."""
    import tempfile

    from theora_tpu_torch.tools import play

    with open(os.path.join(TESTDATA, f"{HD_NAME}.sha256")) as f:
        want = f.read().split()
    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "out.y4m")
        _reset_counts()
        t0 = time.perf_counter()
        play.main(["--stats-only", "-o", out,
                   os.path.join(TESTDATA, f"{HD_NAME}.ogv"), "--device",
                   "cuda"])
        wall = time.perf_counter() - t0
        with open(out, "rb") as f:
            data = f.read()
    frames = data.split(b"FRAME\n")[1:]
    got = [hashlib.sha256(fr).hexdigest() for fr in frames]
    if got != want:
        raise AssertionError(f"play: {len(got)} frames, "
                             f"{sum(a == b for a, b in zip(got, want))} "
                             f"equal the list of {len(want)}")
    c = _tool_counts("play 720p", ("K1 decode", "KS"), ("KP",))
    log(f"[13e] play --stats-only -o: all {len(got)} y4m frames equal "
        f"{HD_NAME}.sha256; wall {wall:.4f} s (a warm-up decoder's first "
        f"frame included); launches {c} | {smi}")


def tools_audio(smi: str) -> None:
    """13 (f): enc -a on a WAV this phase writes, where the system's
    libvorbis loads: the device and the host branch; the A/V file holds
    the video stream of the same encode without audio and a Vorbis
    stream that decodes to the WAV's length."""
    import tempfile
    import wave

    from theora_tpu_torch.ogg import PageReader
    from theora_tpu_torch.tools import enc, vorbis
    from theora_tpu_torch.tools.y4m import write_y4m

    if not vorbis.available():
        log(f"[13f] libvorbis is absent on this machine: enc -a not run "
            f"| {smi}")
        return
    mk = _load_testdata("make_hd720_enc")
    rate, n = 44100, 44100
    with tempfile.TemporaryDirectory() as td:
        wav = os.path.join(td, "a.wav")
        t = np.arange(n) / rate
        pcm = np.stack([np.sin(2 * np.pi * 440 * t),
                        np.sin(2 * np.pi * 550 * t)], axis=1)
        with wave.open(wav, "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(2)
            w.setframerate(rate)
            w.writeframes((pcm * 16000).astype("<i2").tobytes())
        y4m = os.path.join(td, "v.y4m")
        write_y4m(y4m, mk.clip64x48_frames(6))
        for branch in ([], ["--host"]):
            outs = {}
            for audio in ([], ["-a", wav]):
                path = os.path.join(td, f"{len(audio)}.ogv")
                _reset_counts()
                enc.main([y4m, path, "-q", "40", "-k", "4", *branch, *audio,
                          "--device", "cuda"])
                per = {}
                with open(path, "rb") as f:
                    for sn, p in PageReader(f.read()).packets():
                        per.setdefault(sn, []).append(p)
                outs[bool(audio)] = per
            video = list(outs[False].values())[0]
            av = outs[True]
            vids = [v for v in av.values() if v[0].data[:7] == b"\x80theora"]
            auds = [v for v in av.values() if v[0].data[:7] == b"\x01vorbis"]
            if ([p.data for p in vids[0]] != [p.data for p in video]
                    or len(auds) != 1):
                raise AssertionError(f"enc -a {branch}: the A/V file's "
                                     f"streams are wrong")
            dec = vorbis.VorbisDecoder(auds[0][:3])
            got = sum(len(dec.decode(p)) for p in auds[0][3:])
            if abs(got - n) > 2048:
                raise AssertionError(f"enc -a {branch}: {got} samples "
                                     f"decoded of {n}")
            c = _counts_all()
            TOOLS_COUNTS[f"enc -a {' '.join(branch) or 'device'}"] = c
            log(f"[13f] enc -a {' '.join(branch) or '(device branch)'}: "
                f"video equal to the encode without audio, Vorbis "
                f"{len(auds[0]) - 3} packets decoding to {got} samples of "
                f"{n}; launches {c} | {smi}")


def tools_phase(smi: str) -> None:
    """13: the tools on the card, (a)-(f)."""
    t0 = time.perf_counter()
    tools_sweep(smi)
    tools_crosscheck(smi)
    tools_collect(smi)
    tools_profile(smi)
    tools_play(smi)
    tools_audio(smi)
    log(f"[13] the tools' phase took {time.perf_counter() - t0:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    name, smi = card()
    build()
    dev = torch.device("cuda")
    k1 = kernel_vs_plain(dev)
    kl_golden, ks_golden = golden_streams()
    decode = real_size(smi)
    kp_golden = pp_goldens()
    decode_pp = real_size_pp7(smi)
    k2 = k2_vs_plain(dev)
    kt = kt_vs_plain(dev)
    kr = kr_vs_plain(dev)
    km = km_vs_plain(dev)
    kl = kl_vs_plain(dev)
    ks = ks_vs_plain(dev)
    kp = kp_vs_plain(dev, smi)
    small_encodes()
    kl_mesh_small = mesh_filter_small()
    paths = {"encode q48 aq off": real_size_encode(
        smi, "hd720_q48_k8_enc", 48, False)}
    # The main encode path: the JAX encoder's default, adaptive
    # quantization "auto", which engages the qi triple at q56.
    paths["encode"] = real_size_encode(smi, "hd720_q56_k8_aq_enc", 56,
                                       "auto")
    # KR's path: speed level 2, the R/D quantizer in the trellis' place.
    paths["encode q48 speed 2"] = real_size_encode(
        smi, "hd720_q48_k8_sp2_enc", 48, "auto", splevel=2)
    # The loop filter's path: qis 30-42 filter every frame of both passes.
    (paths["encode 2-pass 2 Mbit/s"], kl_twopass_decode,
     ks_twopass_decode) = real_size_twopass(smi)
    paths["transcode"] = transcode_720p(smi)
    paths["encode stage by stage"] = pipelined_vs_staged(smi)
    paths["decode per packet"] = packet_decode_720p(smi)
    segments = mesh_kernels(smi, dev)
    # The mesh slice's main path: both GOPs of the 720p q56 clip in one
    # dispatch.
    paths["mesh"], paths["mesh speed 2"] = mesh_720p(smi)
    for way, c in mesh_vs_sequential(smi).items():
        paths[f"24 frames q48 {way}"] = c
    # The mesh over ranks: two gloo ranks on the card, each launching the
    # path's kernels on its share; per path the two ranks' sum.
    ranks = mesh_ranks_720p(smi)
    rank_paths = {"mesh ranks q56 auto {1,2}": "hd720_q56_k8_aq_enc",
                  "mesh ranks q48 speed 2 {1,2}": "hd720_q48_k8_sp2_enc",
                  "mesh ranks q48 off {2,1}": "hd720_q48_k8_enc"}
    for label, listed in rank_paths.items():
        paths[label] = tuple(sum(c[i] for c in ranks[listed])
                             for i in range(7))
    # The batch intra encoder's slice: the compute core (K1's decode entry
    # and K2) and the batch encoder on its main path (K2 only).
    intra_core, intra_kern = intra_core_720p(smi, dev)
    paths["intra core"] = (intra_core[0], intra_core[1], 0, 0, 0, 0, 0)
    paths["intra encode"] = (*intra_encode_720p(smi), 0, 0, 0, 0, 0)
    intra_small()
    # The host Encoder's slice: its inter path with the closed loop on the
    # card (K1's and KS's decode entries), and the GOP-parallel transcodes
    # over it.
    for label, fn in (("host encode", host_encode_720p),
                      ("host transcode", host_transcode_720p),
                      ("distributed", distributed_720p)):
        k1_host, ks_host = fn(smi)
        paths[label] = (k1_host, 0, 0, 0, 0, 0, ks_host)
    # The th_* encode API's slice: th_enc_ctx under a target bitrate at
    # 720p (the host Encoder drops frames; its closed loop filters, so KL
    # runs beside K1's and KS's decode entries), the small compat and
    # legacy cases and the CLI's --host branch.
    for label, fn in (("host th_enc_ctx 720p CBR", compat_cbr_720p),
                      ("compat and legacy 64x48", lambda smi: compat_small()),
                      ("enc --host 60x44", enc_cli_host)):
        k1_host, kl_host, ks_host = fn(smi)
        paths[label] = (k1_host, 0, 0, 0, 0, kl_host, ks_host)
    host_small()
    enc_cli_workers(smi)
    # The tools' slice: its main path is the quality sweep (13a).
    tools_phase(smi)
    # K1 runs on every main path: the decodes, the encode, the transcode,
    # the mesh, the intra core; K2 on those encode paths and the batch
    # intra encoder; KT on the encode, the transcode and the mesh.
    main_paths = ("encode", "transcode", "decode per packet", "mesh",
                  "intra core", "intra encode", "host encode",
                  "mesh ranks q56 auto {1,2}", "host th_enc_ctx 720p CBR")
    sweep = TOOLS_COUNTS["qualitysweep 720p"]
    k1["launches"] = (decode["K1 decode"]
                      + sum(paths[p][0] for p in main_paths)
                      + sweep["K1 decode"] + sweep["K1 encode"])
    k2["launches"] = sum(paths[p][1] for p in main_paths) + sweep["K2"]
    kt["launches"] = sum(paths[p][2] for p in main_paths) + sweep["KT"]
    kr["launches"] = (paths["encode q48 speed 2"][3]
                      + paths["mesh speed 2"][3]
                      + paths["mesh ranks q48 speed 2 {1,2}"][3])
    km["launches"] = sum(paths[p][4] for p in main_paths) + sweep["KM"]
    # KL runs where a frame's qi is below 47: the 2-pass encode and the
    # decode of its packets, the golden decodes, the small mesh and the
    # host Encoder's closed loop under a target bitrate.
    kl_extra = {"golden decodes": kl_golden,
                "decode of the 2-pass packets": kl_twopass_decode,
                "mesh 64x48 CBR gop axis 4": kl_mesh_small}
    kl["launches"] = (paths["encode 2-pass 2 Mbit/s"][5]
                      + paths["host th_enc_ctx 720p CBR"][5]
                      + sum(kl_extra.values()) + sweep["KL"])
    # KS launches on its own once per plane per decoded frame, and once
    # per plane per frame step on a frag group's ranks (its place entry);
    # on an encode step its work runs inside K1's, K2's and KR's fused
    # entries, whose launches are listed by path too.
    ks_extra = {"golden decodes": ks_golden,
                "decode of the 2-pass packets": ks_twopass_decode}
    ks["launches"] = (decode["KS"] + sum(paths[p][6] for p in main_paths)
                      + sweep["KS"])
    ks["launches_in_fused_entries_by_path"] = dict(KS_FUSED)
    for k, entry in ((k1, "mc_idct_recon_skip"), (k2, "mc_fdct_quantize"),
                     (kr, "mc_fdct_quantize_rd")):
        k["fused_with_ks_ms"] = {label: r for label, r in ks["fused"].items()
                                 if label.startswith(f"{entry},")}
    for i, (k, key) in enumerate(((k1, "K1 decode"), (k2, "K2"),
                                  (kt, "KT"), (kr, "KR"), (km, "KM"),
                                  (kl, "KL"), (ks, "KS"))):
        k["launches_by_path"] = {"decode": decode[key],
                                 **{p: c[i] for p, c in paths.items()}}
        k["launches_by_rank"] = {label: [c[i] for c in ranks[listed]]
                                 for label, listed in rank_paths.items()}
    for k, key in ((k1, "K1"), (k2, "K2"), (kt, "KT"), (kr, "KR")):
        k["mesh_3_segments_ms"] = {"one_launch": segments[key][0],
                                   "three_launches": segments[key][1]}
    kl["launches_by_path"].update(kl_extra)
    ks["launches_by_path"].update(ks_extra)
    # The tools' paths (13): every kernel's launches on each, K1's decode
    # and encode entries apart.
    for k, keys in ((k1, ("K1 decode", "K1 encode")), (k2, ("K2",)),
                    (kt, ("KT",)), (kr, ("KR",)), (km, ("KM",)),
                    (kl, ("KL",)), (ks, ("KS",)), (kp, ("KP",))):
        k["launches_by_tool_path"] = {
            path: (c[keys[0]] if len(keys) == 1
                   else {key: c[key] for key in keys})
            for path, c in TOOLS_COUNTS.items()}
    k1["intra_core"] = intra_kern["K1"]
    k2["intra_core"] = intra_kern["K2"]
    # KP runs where a pp level is set: the 720p decode at pp 7 (the
    # slice's main path, by batch and per packet) and the pp goldens;
    # every pp 0 path launched none (checked where their counts are read).
    kp["launches"] = (decode_pp["decode pp7"]
                      + decode_pp["decode per packet pp7"])
    kp["launches_by_path"] = {
        "decode pp7": decode_pp["decode pp7"],
        "decode per packet pp7": decode_pp["decode per packet pp7"],
        "pp goldens (pp 2, pp 7)": kp_golden, "decode (pp 0)": decode["KP"]}
    kp["pp7_warm_walls_s"] = decode_pp["pp7 warm walls_s"]
    kp["pp7_traced_device_share"] = decode_pp["pp7 traced share"]
    kp["pp7_traced_s"] = decode_pp["pp7 traced KP s"]
    print(json.dumps({"kernels": [k1, k2, kt, kr, km, kl, ks, kp]}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
