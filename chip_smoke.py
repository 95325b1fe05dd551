#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (minio_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root
    python3 chip_smoke.py --parent DIR   # and K1-K13 beside an older copy

1. Builds the CUDA kernels from ``minio_tpu_torch/csrc`` with nvcc into
   one library (and ``--parent``'s copy into its own), one ``nvcc -c``
   per source (codec.cu, select.cu, the copy's codec.cu) all at once,
   prints each library's and each source's build seconds and each
   kernel's registers and spills and the static SASS of K1, K4 and K5
   (EC 8+4, swar and mxu), K2, K3, K6, K7 (4 x 8), K8 (each lookahead), K9, K10
   (both forms), K11, K12 and K13 (``sass_loops``).
2. Holds each kernel bit-exactly against its plain PyTorch version on the
   card, at the main path's shapes (EC 8+4, 10 MiB blocks: 327,680 words
   per shard) and at ragged ones, and times kernel, plain version and the
   bound (bytes or operations at the card's published peaks).
   Heal's kernels get the same: verify_reconstruct (K4) at heal's batch
   of one block and at B = 4 over three survivor patterns, also against
   gf_matmul_words, phash256_host_batched and data that encode_pack
   encoded, with a bitrotted survivor that the backend must re-solve;
   and encode_pack without the pack leg (the P2 function, heal's
   re-encode) at heal's shape.  The overlap kernels too: the pipelined
   K5 and K6 against their plain versions and against K1 and K4, and the
   sub-chunk forms of K1 and K4 chained over S chunks against the
   whole-row pass and against their plain chains.  The mxu formulation
   too: K7 gf_matmul_mxu and the ``mxu`` instantiations of K1, K4, K5
   and K6 against their plain versions and their swar twins, at the main
   path's and heal's shapes and at ragged ones; K1 ``mxu`` also at every
   geometry of ``encode_geometry_sweep`` and on an unaligned view, K4
   ``mxu`` and K6 ``mxu`` also at 1 to 8 rebuilt rows and other row
   buckets, K4 ``mxu`` also on an unaligned view (``vr_mxu_sweep``), K4
   swar on an unaligned view too.  K2 also at row counts
   off its 4-row group, widths off its 1,024-word tile and an unaligned
   view; K6 and K6 ``mxu`` also against their plain versions and K4 for
   every EC 8+4 survivor pattern with 0-4 rows absent.  K1 also at one
   (k, m) of each row bucket and at EC 8+4, 12+4 and 4+2, against its
   plain version, K5 and K5 ``mxu`` (``encode_geometry_sweep``); K3 for
   every EC 8+4 and 4+2 survivor pattern, edge matrices, a width off the
   4-word quad and an unaligned view (``gf_pattern_sweep``).  S3 Select's
   K8-K11 (``csrc/select.cu``, in the same library as the codec's)
   against their plain versions on a 32 MiB TPC-H lineitem chunk (one
   DEV_CHUNK): K8 under the screens of Q1-Q4, of an IN list of 16 options
   (row and field anchored), of one of 150 (past the records a launch
   passes by value), of every atom kind (both anchors, sci guard on and
   off) and of one program for each lookahead of 1-6 words, on a hazard
   chunk and on the SWAR-borrow planes (the borrow within a word's half
   and from lane 3 into lane 4); K9 at every program's candidates (the
   whole output, ranks past the count included), beside
   ``torch.nonzero`` of the candidate bytes; K10
   at the three row windows and backwards, also over rows 10-6,000 bytes
   wide; K11 at 4-4,096-byte windows, at every start alignment and plane
   offset, clamped at both ends of the plane (``check_select_kernels``).  Beside each kernel's
   back-to-back event time (``ms``): its device time from a replayed
   CUDA graph, the host's time per wrapper call and its L2-cold times
   after 512 MiB written and after 512 MiB read (``device_times``), and
   for K1, K3, K6 and K7 a one-tile launch (the fixed chain); K7 also every (output, row) bucket, ragged, sub-tile and
   unaligned shapes against K3, and its ``clock64`` phases per block
   (``check_k7``, ``k7_phases``).  With ``--parent``, K1-K7 of both
   copies at the main path's shapes in turns parent, new, new, parent
   (``compare_copies``), then K8 under Q1, Q2, the IN list's field
   screen and two long lookaheads on the lineitem chunk, K9 at Q1's and
   Q2's candidates, K10 at Q1's anchors and backwards at Q2's hits, and
   K11 at Q1's gather and at one row, in the same turns (``compare_select_copies``), the card's name and
   power limit printed before them, then K12 and K13 at the main path's
   plane and heal's in the same turns (``compare_legacy_copies``).  The
   legacy drain's K12 group_flags and K13 pack_nonzero_groups against
   their plain versions and against the flags and ``packed`` of K1's
   and K5's own pack legs, at the main path's parity plane (4, 4,
   327,680), heal's B = 1, ragged B and the edges of K13's cluster split
   (``LEGACY_EDGES``: g below and not a multiple of the cluster, rows
   past one cluster's shared memory), each dense, sparse, all zero, one
   nonzero word a group, no zero word and one nonzero word in each row's
   first or last group, and on views 4 bytes off alignment; K12 also at
   runs other than its plan's (``K12_RUNS``); K13 one count a call
   (``check_legacy_kernels``).  Both timed at the main path's plane and
   heal's, their device times over a rotation of distinct planes past
   the L2 (``legacy_planes``), K12 beside ``plane.view(B, m, g,
   256).any(-1)``, and K12 on one group (the fixed cost of a launch in
   each time).  ``--only legacy`` also checks by the profiler that K13 is
   one kernel a call and times K12 at each run of ``K12_SWEEP`` (one
   group a warp up to a persistent grid of long runs).
2b. The port's static analysis (``analysis_phase``, slice 10b): ``python
   -m minio_tpu_torch.analysis --json --skip lint locks deviceflow
   lifecycle`` as a subprocess must exit 0 with no finding (the four
   skipped passes read only the source, so the CPU tests gate them);
   its contracts pass, on the card by default, must run every kernel
   wrapper (K1-K13) and every mesh kernel (over ``(cuda:0,) * 4``) on
   CUDA tensors over the JAX package's grids, each output equal to its
   plain version, and every kernel's LAUNCHES must move in that run; every ``mtt_*``/``mts_*`` export the ABI pass reads
   from the CUDA sources must resolve in the library built in step 1.
   Prints the ``analysis:`` line (seconds per pass, findings, contracts
   checked, launches per kernel); each kernels row gains its
   ``analysis`` launches.
3. Drives the main path through the object layer under the default
   MINIO_TPU_CODEC_OVERLAP (unset: ``pipeline`` on the card): 12 temp-dir
   disks, EC 8+4, 10 MiB blocks; PUT four 64 MiB objects and one of
   10 MiB + 17 bytes, GET each healthy and again with 4 disks offline
   (data-shard disks among them), compares every body with its source,
   compares the part files of the 10 MiB + 17 object with those the same
   port writes on the CPU, and checks that every kernel of that path
   launched (K5 on PUT, and K1 not at all).
4. Heals the same 5 objects on the same disks: 4 shards deleted from each
   64 MiB object and healed with heal_object; on the last object one
   shard bitrotted and 3 deleted, healed by the MRF HealRoutine after a
   GET flags it.  Every rebuilt part file must equal the one it replaces;
   then each object is read with 4 other disks offline, so the healed
   shards carry the read.  K6 and K1 without the pack leg must launch,
   and K4 must not.
5. Every mode against every other: on fresh disks, under ``pipeline``,
   ``off``, ``async`` and MINIO_TPU_CODEC_KERNEL=legacy (under ``async``,
   which legacy ignores; its first turn under
   MINIO_TPU_DEVICE_COMPRESS=on, its second under auto) in turn, PUT one
   64 MiB object and the 10 MiB + 17 B one, GET both with 4 disks offline, delete 4 shards of each and
   heal_object them.  Part files must be byte-identical to the main
   path's, and xl.meta equal up to its mod time, data dir and version id
   (fresh for every PUT); each mode's own kernels must launch and
   ``async`` must count overlap windows both ways.  Legacy launches K1
   without the pack leg, K12 (and K13 exactly in the ``on`` turn), K2
   and K3, and no K4, K5, K6 or sub-chunk pass.
6. MINIO_TPU_CODEC_FORMULATION=mxu, on fresh disks: under ``pipeline``
   and under ``off``, then swar under ``off`` after them, the same two
   objects PUT, read with 4 disks offline and healed.  Part files must equal the main path's; under mxu the
   ``[mxu]`` kernels must launch and the swar PUT and heal-read kernels
   must not, while heal's re-encode stays on swar K1.
6b. The device mesh (``mesh_phase``, slice 10a): the mesh entry points
   of ``minio_tpu_torch/parallel/mesh.py`` over slots that repeat the
   card, (4, 1), (2, 2) and (1, 4) of 4 slots at EC 8+4 and (2, 3) of 6
   at EC 12+4 (the XOR all-reduce's fold), 10 MiB blocks, B = 4:
   sharded_encode, sharded_encode_seq, mesh_encode_hash and its
   begin/end, mesh_reconstruct with 4 data shards absent,
   mesh_verify_reconstruct with a bitrotted survivor, mesh_digest, each
   bit for bit against the single-device kernels; then one erasure set
   whose codec is ``BatchingBackend(instrument(TorchBackend(devices=(dev,)
   * 4)))`` under MINIO_TPU_PLACEMENT=span, route and auto
   (MINIO_TPU_SUBMESH_DEVICES=1): PUT, healthy GET, GET with 4 drives
   offline, heal; bodies equal their sources, part files and xl.meta a
   single-slot backend's.  K1-K4 must launch in the mesh runs.  Prints
   the ``mesh:`` line (each shape's entry points' wall ms and launches,
   each policy's MB/s, placement counters and submesh depth peaks).  No
   speed is claimed: the slots share one card.
7. The S3 front: the port's S3Server (threaded plane,
   MINIO_TPU_SERVER=threaded) over a fresh ErasureObjects on the card (12 disks,
   EC 8+4, 10 MiB blocks), driven through SigV4 over HTTP by this
   script's own signer (``S3Signer``, on minio_tpu_torch.server.auth):
   bucket create and policy (a bucket document, erasure-coded in
   ``.sys``), a 1 KiB object read back anonymously under the policy, the
   10 MiB + 17 B object (its part files must equal the main path's), 4
   clients PUTting two 64 MiB objects each at once (one aws-chunked),
   every object read back by 4 clients healthy and again with the disks
   of shards 1, 3, 10 and 12 offline, a ranged GET across a block
   boundary, HEAD of each, ListObjectsV2 paged by 3, then DELETE of
   each, a 404 and the bucket's delete.  K5, K2 and K3 must launch and
   K1 must not; at least one batcher flush must merge jobs of more than
   one client.  Prints the ``s3:`` line.
8. Multipart and copies, on a fresh S3Server and disks of the same
   deployment: 4 clients upload a 64 MiB object each as 8 x 8 MiB parts
   at once, then the 10 MiB + 17 B object goes up as 5 MiB, 5 MiB and
   17 B parts; ListParts, and each CompleteMultipartUpload alone (no
   launch; the object's shard files are the staged ``part.N`` files,
   hashed per disk; the ETag is md5 of the part md5s, "-N"); one 8 MiB
   part against a single PUT of it by erasure index; an upload listed
   by ListMultipartUploads, aborted, gone from every disk; GETs by 4
   clients healthy and with shards 1, 3, 10, 12 offline, and a ranged
   GET across a part boundary; an UploadPartCopy upload from two
   ranges plus a part, a 64 MiB CopyObject and a REPLACE self-copy;
   heal of a multipart object's deleted part files on 4 disks (K6, K1
   without the pack leg), read through the healed shards;
   ListObjectVersions paged by one, a POST-policy upload and a quiet
   multi-delete after which every GET answers 404.  K5 (with merged
   jobs) covers every part, K3 runs on the degraded GETs, K2 and K5 on
   the copies.  Prints the ``s3_mp:`` line.
8b. Server-side encryption and compression (``sse_phase``): a fresh
   S3Server over TLS (a self-signed certificate for 127.0.0.1 from the
   openssl CLI) and disks of the same deployment, SSE-S3 keys from
   MINIO_TPU_KMS_MASTER_KEY (a key made from SEED).  First 4 x 64 MiB
   without SSE over the same TLS (the baseline).  SSE-C: 4 clients
   PUT and GET 8 x 64 MiB, range GETs at 65,436+200, 10,485,660+200 and
   the last 17 B of each, one GET with the disks of shards 1, 3, 10 and
   12 offline, a wrong key answered 403 AccessDenied; SSE-S3: a bucket
   default set by ``PUT ?encryption``, 4 x 64 MiB PUT without a header and
   read back with ``x-amz-server-side-encryption: AES256``, the admin
   ``kms/key/status`` round trip; compression (MINIO_TPU_COMPRESS=on): 4
   x 64 MiB of lineitem text and one compressed+SSE-C copy of it, the
   stored/actual ratio, a GET and a range GET, Select Q1 over the
   compressed and the SSE-C object against the host engine's Records over
   the plain text; an SSE-C multipart upload of 4 x 8 MiB and a GET across
   a part boundary; CopyObject SSE-C -> SSE-S3 of 64 MiB; one shard of an
   SSE-C object deleted and healed.  Every body must equal its source;
   K5, K2, K3, K6, K1 without the pack leg and K8-K10 must launch.  Also
   times EncryptReader/DecryptWriter and CompressReader/DecompressWriter
   alone over 64 MiB in memory.  Prints the ``sse:`` line.
9. S3 Select (``select_phase``): on a fresh S3Server and disks of the
   same deployment, a 256 MiB TPC-H lineitem CSV (``lineitem_csv``, 8
   DEV_CHUNKs) is PUT and queried through ``POST ?select`` by Q1-Q4
   (``SELECT_QUERIES``) under the default engine and under
   MINIO_TPU_SELECT=host (Records byte-identical), Q1 on 16 MiB against
   the ``row`` engine, Q1 with 4 disks offline, Q1 and Q2 by 4 clients at
   once; the fallbacks must be SELECT_FALLBACK's on every chunk, the
   ``miniotpu_select_*`` families must move, ``run_device`` over
   ``as_device_plane`` of the object on the card must answer Q1 (K11),
   and K8-K11, K2 and K3 must launch.  Prints the ``select:`` line.
9b. The tiered read cache (``read_cache_phase``): on a fresh S3Server and
   disks of the same deployment with MINIO_TPU_READ_CACHE=device (the hot
   tier on the card) and RC_ENV's 1 GiB tiers and 2 GiB budget, 8 x 64
   MiB PUT (populating the device tier) and read 4 times by 4 clients,
   all device hits; 16 x 64 MiB PUT and read once, after which every hot
   group is still on the device; one hot GET through the object layer
   with no disk call but the bucket check (K2 launches counted); a byte
   flipped in a device-tier tensor dropped by the hit's verification
   (``verify_drops``), served from disk and admitted again; the cache
   cleared and shards 1, 3, 10, 12 offline: the miss launches K3 and K2
   and admits the rebuilt rows, the next GET a device hit; invalidation
   by overwrite, DELETE (404), ``heal_object`` and
   ``update_object_meta`` (the FileInfo side-car entry drops); the admin
   ``read-cache-clear``, then Select Q1 over the 256 MiB lineitem object
   scanned from the device tier (``device_scan_source``, no shard reader
   opened, K8-K11) against the host engine's Records; admin
   ``read-cache-stats``, healthinfo and the ``miniotpu_cache_*``
   families against the cache's stats; last the hot set's GET MB/s
   under ``host`` and ``off``, the cache reset between modes.  Prints
   the ``read_cache:`` line.
9c. Bucket configurations enforced by the data crawler
   (``bucket_config_phase``, slice 9c's first half and 9d's crawler): the
   same deployment built as the server main builds it (zones over one set
   of 12 guarded drives, the MRF heal routine, ``start_crawler``'s update
   tracker and data crawler).  A bucket born with object lock and a
   GOVERNANCE default retention of one day takes 4 x 64 MiB with
   ``x-amz-tagging`` from 4 clients (K5) and reads them back (K2), one with
   the drives of shards 1, 3, 10, 12 offline (K3); tags and retentions
   read back; a retained version refuses its delete (InvalidRequest), the
   root's governance bypass deletes it, a legal hold refuses even the
   bypass.  128 x 4 KiB objects over 8 prefixes through the object
   layer, under a lifecycle rule with an Expiration Date in the past for
   ``p3/``; a lock-enabled bucket with a FIFO quota over 12 x 1 MiB, one
   retained; one tagged object's files deleted from one drive.  The admin
   ``crawl`` expires exactly ``p3/`` (GETs answer NoSuchKey), evicts
   oldest first down to the quota past the retained object, and queues
   the damaged object's heal, which the routine restores part file for
   part file (K6, K1 ``group=0``); ``datausage`` equals ListObjectsV2 of
   every bucket; a second crawl skips the untouched bucket.  Prints the
   ``bucket_config:`` line (crawl seconds and objects per second,
   expired, evicted and healed counts, tagged PUT/GET MB/s beside the S3
   phase's, launches, the card).
10. The server as users start it (``boot_phase``): ``python -m
   minio_tpu_torch.server --parity 4`` over 24 temp-dir drives in a
   process of its own, on the async plane and the card (neither
   MINIO_TPU_SERVER nor MINIO_ERASURE_BACKEND set), the fresh-disk
   monitor every second.  Boot until readiness answers 200 (each
   drive's format.json: 2 sets x 12, one deployment id; loops/status
   async; 24 drives online); 4 SigV4 clients PUT 8 x 64 MiB and the
   10 MiB + 17 B object at once (both sets hold objects), GET every one;
   drive 5 (set 0) wiped while the server runs: stamped back with its
   uuid and every set-0 object healed onto it, its files equal to those
   before the wipe; one part file of a set-1 object deleted and healed
   through the admin API; SIGTERM (exit 0, ``shutdown complete``); drive
   17 (set 1) wiped while the server is down, then a restart over the
   same drives: the same deployment id, drive 17 stamped by the hole
   fill and healed by the sweep, every GET equal to its source, SIGTERM.
   The admin ``kernel-stats`` is read around each step (device passes,
   batcher flushes, merges, wait seconds).  Last, one Q1 select over a
   16 MiB lineitem object on the restarted server, against the host
   engine's answer, with ``miniotpu_select_requests_total{engine="device"}``
   at least 1.  Prints the ``boot:`` line.
11. Four nodes, one erasure set (``cluster_phase``, slice 9b): four
   ``python -m minio_tpu_torch.server`` processes on this one card,
   spawned by the port's ClusterHarness (cluster/harness.py) with the same
   16 ``http://127.0.0.1:P_j/.../d{1..4}`` endpoints - one set of 16
   drives at the default parity, EC 8+8, the 4-node, 4-drive layout of
   MinIO's distributed-mode guide - on the async plane with the harness's
   fast lock and heal cadences, node 1 with MINIO_TPU_READ_CACHE=device.
   All four boot at once (spawn to ready each; the 16 format.json agree);
   4 SigV4 clients, client i on node i, PUT 8 x 64 MiB and each object is
   read back from another node (sha256); the first object's part files
   and xl.meta on all 16 drives are held against the port's plain CPU
   codec writing the same bytes; 2 rounds of concurrent PUTs of one key
   through nodes 1 and 3 (one of the two bodies, one xl.meta generation
   on every drive, top-locks empty after); 4 rounds of read-after-write
   across nodes (node 1 reads a hot object twice, from the device tier
   once admitted, node 2 overwrites it, node 1's GET right after the ack
   returns the new body; node 1's peer-driven invalidations counted);
   node 4 SIGKILLed: nodes 1-3 return every object (K3 launches), 4 PUTs
   succeed at write and lock quorum, node 4 restarts over the same drives
   and an admin heal on node 1 puts the missed shards on its drives, equal
   on all 16 drives to the plain codec's; every acknowledged object read
   back from every node; SIGTERM, each node exits 0.  A
   ListenBucketNotification stream on node 1 (open before the 16 PUTs)
   hears every PUT's ObjectCreated:Put record, the 12 made through nodes
   2-4 over the peer plane (listenon/listenbuf), and once it closes node
   3 holds no listener (listenoff; admin ``listen-stats``).  Each node's kernel
   launches come from its admin ``kernel-stats`` (K5 on every node's PUTs,
   K2 on its GETs, K6 and K1 ``group=0`` on the heal).  Node 1 heals
   once it counts all 16 drives online (admin ``storageinfo``) with every
   breaker closed (the harness's ``disk_states``): a drive that went down
   is probed again only every few seconds.  Prints the ``cluster:`` line;
   ``phases_s`` gains ``cluster``.
12. Heal sequences (``heal_seq_phase``, slice 9d, after ``bucket_config``):
   the S3 phase's deployment (S3Server, threaded plane, 12 disks, EC 8+4);
   6 x 64 MiB objects, two drives' payload wiped (``.sys`` kept); a dry
   run reports all 6 and writes nothing; ``POST heal-sequence`` polled by
   client token until ``finished``: every part file and xl.meta equal to
   before the wipe, 6 healed, the bucket and each object popped once,
   HealAlreadyRunning, HealOverlappingPaths and HealInvalidClientToken
   while it runs, K6 and K1 ``group=0`` launched; a third drive wiped,
   ``heal-sequence/stop`` in mid-walk ends ``stopped`` and a forceStart
   launch heals the rest.  Prints the ``heal_seq:`` line.
13. Federation (``federation_phase``, slice 9d, after ``cluster``): two
   ``python -m minio_tpu_torch.server`` processes on the card, 12 drives
   each, sharing MINIO_TPU_FEDERATION_DIR; B answers 307 to A for A's
   bucket (round trip timed), 4 clients PUT (Expect: 100-continue) and GET
   4 x 64 MiB through the redirect (K5 and K2 on A, nothing on B), racing
   creates give one 200 and one BucketAlreadyExists, ListBuckets is the
   union, a DELETE frees the name for B.  Prints the ``federation:`` line.
13b. Bucket replication, events and the disk cache
   (``replication_phase``, slice 9c, after ``federation``): two servers
   on the card, A and B, 12 drives each; A's versioned ``src`` replicates
   to B's ``dst`` (``set-remote-target``, one rule), sends its bucket
   events to a loopback webhook through a queue directory and fronts its
   object layer with the disk cache.  4 clients PUT 4 x 64 MiB (K5 on
   A); HEAD reads each COMPLETED (lag from the ack), B holds each (K5 on
   B, K2 on A's replication reads; the first one's drives against the
   plain CPU codec); the webhook and a listen stream carry the 4
   ObjectCreated:Put records; 2 records parked while the sink is down
   arrive in order once it is back; 2 PUTs with B down read FAILED,
   then COMPLETED after B's restart and an admin crawl; two GET passes:
   4 disk-cache misses (K2), then 4 hits with no launch; an overwrite
   misses with its new body, a cached range equals the backend's.
   Prints the ``replication:`` line.
13c. The backends without a codec (``backends_phase``, slice 9c, after
   ``replication``): the FS mode (``server <dir>``) and an erasure
   server U of 12 drives on TLS spawned side by side; 4 clients PUT and
   GET 4 x 64 MiB on the FS server (each file under ``<dir>`` holds its
   object's bytes), a multipart upload of 4 x 8 MiB, a copy, a delimiter
   listing, Select Q1 over a 64 MiB lineitem object (K8-K10 on the FS
   server, no K5 or K2); ``server gateway nas <dir>`` then lists and
   reads what the FS server wrote; ``server gateway s3 https://U`` on
   TLS: 4 clients PUT and GET 4 x 64 MiB through it (K5 and K2 on U, no
   launch on the gateway; the first object on U's drives against the
   plain CPU codec), an SSE-C object PUT, read and copied through it and
   held sealed on U, Select Q1 on U's object scanned on the gateway's
   card.  Prints the ``backends:`` line.
13d. The web plane (``web_phase``, slice 9c, after ``backends``): the
   server CLI over 12 drives (EC 8+4, 10 MiB blocks) on the async plane,
   an OpenID provider stub on loopback with an RSA key made here;
   ``web.Login`` as the root and an IAM user, 4 clients upload 4 x 64 MiB
   through ``/minio-tpu/web/upload`` (K5; part files equal an S3 PUT's),
   download each by URL token (K2) and zip all of them in one POST
   (every entry unzipped and checked), then the downloads and a zip of
   one object with the drives of 4 of its shards failing (K3); a
   presigned GET; STS ``AssumeRole`` (its
   credential PUTs and GETs 64 MiB, a read-only session policy's PUT is
   403) and ``AssumeRoleWithWebIdentity`` (its credential GETs);
   ``ListObjects``, ``RemoveObject``, the console page.  Prints the
   ``web:`` line: upload, download and zip MB/s, degraded download MB/s,
   AssumeRole and WebIdentity ms, each a median of a few calls.
13e. Quorum-early parity acks (``parity_ack_phase``, slice 11, after
   ``web``): two server CLIs over 12 drives each (EC 8+4, 10 MiB blocks,
   async plane, MINIO_TPU_FAULT_INJECTION=1), one under
   MINIO_TPU_PARITY_ACK=settle and one under ``early``; 4 clients PUT 4 x
   64 MiB to each in turns (settle, early, early, settle), each PUT's
   time to ack and the round's MB/s, a GET right after each ack; the same
   with one drive slowed (``delay_s`` on its writes) that holds a parity
   shard of every object of the round; then a parity drive's
   ``rename_data`` failing once behind an early ack:
   ``miniotpu_codec_stream_heal_required_total`` moves by one and the MRF
   heal puts the drive's part file back, equal to settle's by erasure
   index.  Prints the ``parity_ack:`` line with the card's name and power
   limit.
14. The chaos grid (``grid_phase``, slice 9d): the first four cells of
   ``GRID_ORDER`` (``GRID_RUN``: heal_storm, dead_remote_disks,
   replication_lag_churn, select_heavy_mix) on
   3-node clusters on the card with the JAX grid's invariants, each
   node's launches from its ``kernel-stats``; each timed GET flood's
   stage breakdown (``get_stages``: the 5 slowest GETs and the median,
   each joined by request id to the serving node's admin
   ``request-stages``).  Prints a ``grid <cell>:`` line per cell and the
   ``grid:`` line.
15. Prints the kernels JSON line, the card's name and power limit, and as
   the last line ``{"ok": true, "device": {...}}``.

Exits non-zero, without the result lines, when there is no CUDA device or
when any phase fails.  ``--only NAMES [--repeat N]`` runs only the named
phases (``legacy``, ``select``, ``cluster``, ``federation``,
``replication``, ``backends``, ``web``, ``parity_ack``, ``mesh``,
``analysis``, or ``grid:CELL[+CELL...]``) after the build, N times in
turn, and prints one line a run and an ``only:`` tally, e.g.
``python3 chip_smoke.py --only grid:select_heavy_mix --repeat 20``.
"""

from __future__ import annotations

import functools
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# The integer XOR/shift/multiply/permute work of these kernels runs on
# the integer pipe: 64 lanes per SM per clock, half the float32 lanes.
# Set in main() from the card: SMs x 64 x the SM clock's maximum.
INT_LANES_PER_SM = 64
INT_OPS_PER_S = 132 * INT_LANES_PER_SM * 1.98e9
# int8 tensor cores, dense (H100 SXM data sheet).  The mxu product's bit
# pairs are held to it: the data sheet gives no rate for the 1-bit MMA the
# kernels issue, so this is an assumption (a faster b1 rate would lower
# the bound).
TC_INT8_OPS_PER_S = 1979e12

K, M, N = 8, 4, 12
BLOCK = 10 * 1024 * 1024
W = BLOCK // K // 4  # 327,680 words per shard
OBJECT_SIZES = [64 << 20] * 4 + [BLOCK + 17]
SEED = 20261016


def fail(msg: str) -> "None":
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    err = SystemExit(1)
    err.message = msg  # what --only's tally prints
    raise err


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_times(fn, reps: int = 20) -> dict:
    """Three times of a wrapper call beside cuda_ms's back-to-back events
    (which measure the host when it enqueues slower than the device runs):

    * ``device_ms``: ``reps`` calls captured in one CUDA graph and
      replayed, per call (device time only, the zeroing memsets included;
      a capture the wrapper does not allow fails the run);
    * ``host_us``: the host's time per call (time.perf_counter around it,
      no synchronisation; median of 100);
    * ``cold_ms``: one call replayed from a graph right after 512 MiB were
      written, so the 50 MB L2 holds none of its input (median of 9);
    * ``cold_read_ms``: the same right after 512 MiB were read, so the L2
      holds none of its input and no dirty line that the call's own
      reads would have to write back first (median of 9)."""
    import statistics

    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph, one = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    with torch.cuda.graph(one):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        e0.record()
        graph.replay()
        e1.record()
        torch.cuda.synchronize()
        runs.append(e0.elapsed_time(e1) / reps)
    host = []
    for i in range(100):
        t0 = time.perf_counter()
        fn()
        host.append(time.perf_counter() - t0)
        if i % 20 == 19:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    flush = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")
    cold, cold_read = [], []
    for _ in range(9):
        flush.fill_(1)
        e0.record()
        one.replay()
        e1.record()
        torch.cuda.synchronize()
        cold.append(e0.elapsed_time(e1))
    for _ in range(9):
        flush.view(torch.int64).sum()
        e0.record()
        one.replay()
        e1.record()
        torch.cuda.synchronize()
        cold_read.append(e0.elapsed_time(e1))
    return {"device_ms": statistics.median(runs),
            "host_us": statistics.median(host) * 1e6,
            "cold_ms": statistics.median(cold),
            "cold_read_ms": statistics.median(cold_read)}


def bound(nbytes: float, ops: float, mma_ops: float = 0.0) -> "tuple[float, str]":
    """(ms, what binds): the larger of the bytes over the memory rate and
    the operations over their pipes' rates (integer ops, plus MMA ops at
    the int8 tensor-core rate)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / INT_OPS_PER_S + mma_ops / TC_INT8_OPS_PER_S
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def int_rate() -> dict:
    """The integer pipe's rate on this card: SMs x 64 lanes x the maximum
    SM clock that nvidia-smi reports."""
    import torch

    global INT_OPS_PER_S
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    mhz = float(smi.stdout.strip().splitlines()[0])
    INT_OPS_PER_S = sms * INT_LANES_PER_SM * mhz * 1e6
    return {"sms": sms, "sm_clock_max_mhz": mhz, "int_ops_per_s": INT_OPS_PER_S,
            "tc_int8_ops_per_s": TC_INT8_OPS_PER_S, "hbm_bytes_per_s": HBM_BYTES_PER_S}


# Operation counts per element, as integer-pipe instructions (one a lane
# a cycle): LOP3 takes any logic of three inputs, so XORing v values
# together takes ceil((v - 1) / 2); IMAD is a multiply and an add.
# mix32 is 3 shifts, 3 xors and 2 multiplies (8); the key is an IMAD and
# a mix32, plus key * kM2 once a column (10); one hashed word is
# LOP3 + IMAD for (w ^ key) * kM1 and one IMAD for w * kM2 + key * kM2,
# then a mix32 each whose last LOP3 also folds into h1 / h2 (19); one
# xtime, ((x & 0x7F7F7F7F) << 1) ^ (sign-spread bytes of x & 0x1D1D1D1D),
# is a LOP3, a shift, a PRMT and a LOP3 (4).
_MIX, _KEY, _HASH, _XTIME = 8, 10, 19, 4


def _xors(v: int) -> int:
    """LOP3s that XOR v values into one."""
    return max(v - 1, 0) // 2 + max(v - 1, 0) % 2


def product_rows(matrix):
    """The rows of a GF product that take operations: a unit row (one
    coefficient, 1) copies its input, whose bytes the bound counts."""
    import numpy as np

    m = np.asarray(matrix)
    unit = (np.count_nonzero(m, axis=1) == 1) & (m.max(axis=1, initial=0) == 1)
    return m[~unit]


def gf_ops(matrix) -> int:
    """Instructions of one column of a GF product as the function needs
    them: none for the rows that are copies (``product_rows``); for the
    others the cheaper of two forms.  Horner's form per output row: from
    its top coefficient bit down, an xtime then the XOR of that bit's
    terms (ceil(c / 2) LOP3s), the top bit's terms XORed together.  A
    chain per input: an xtime per bit below its top one, then per output
    row the XOR of its terms."""
    import numpy as np

    m = np.asarray(product_rows(matrix), dtype=np.int64)
    if m.size == 0:
        return 0
    bits = (m[..., None] >> np.arange(8)) & 1  # (rows, inputs, bit)
    horner = 0
    for row in bits:
        per_bit = row.sum(axis=0)  # terms at each bit
        set_bits = np.flatnonzero(per_bit)
        if set_bits.size == 0:
            continue
        top = int(set_bits[-1])
        horner += _xors(int(per_bit[top]))
        horner += sum(_XTIME + -(-int(per_bit[b]) // 2) for b in range(top))
    tops = [int(np.flatnonzero(col.any(axis=0))[-1]) for col in bits.transpose(1, 0, 2)
            if col.any()]
    chain = _XTIME * sum(tops) + sum(_xors(int(row.sum())) for row in bits)
    return min(horner, chain)


def mxu_ops(o: int, s: int) -> int:
    """MMA ops of one word column (4 byte columns) of the mxu product of an
    (o, s) matrix: the (8o x 8s) bit pairs that matter, counted as
    multiply + add, with no padding of the tile."""
    return 2 * (8 * o) * (8 * s) * 4


# The mxu kernels' own integer work, printed beside the bound as
# ``design_int_ops``, never part of it: the function does not need it.
# 3 byte permutes build a lane's B word per 8 byte columns.
_PERM = 3


# K5 [mxu]'s product (csrc/codec.cu mxu_ring_tile) repacks two m-tiles
# at once: per n-tile and pair of m-tiles, 6 shift-adds gather the 8
# accumulators into two words of bytes, 4 ops (two masks, a multiply-add,
# the multiply by 1 << q) place their bits, 2 shuffles and 2 adds join the
# 4 lanes of a byte, 1 shuffle and 2 permutes the half words of both
# rows, and 2 for the stores' predicates.
_RING_REPACK = 19


def mxu_ring_design_ops(o: int, s: int) -> int:
    """The mxu_ring_tile lanes' permutes and repack per word column; none
    without output rows (K4 [mxu] runs no product then)."""
    if o == 0:
        return 0
    mtiles = -(-o // 2)
    return 32 * (_PERM + _RING_REPACK * -(-mtiles // 2)) // 2


# K7's own product (csrc/codec.cu k7_operands, k7_product) per lane and
# 16-byte chunk, which is per word column (4 lanes share a chunk of 4
# word columns): the A words' byte permutes (3 a word quad with up to 4
# input rows - byte 0 needs none - 1 a word with 8, 2 with 16: a 4 x 4
# byte transpose) and one funnel shift a count (8 m-tiles x bucket(o)
# n-tiles x 4 counts a lane).
_K7_PERMS = {4: 12, 8: 16, 16: 32}


def _row_bucket(v: int) -> int:
    """The kernels' row bucket of v rows (codec.cu bucket)."""
    return 4 if v <= 4 else (8 if v <= 8 else 16)


def k7_design_ops(o: int, s: int) -> int:
    """K7's permutes and funnel shifts per word column."""
    return _K7_PERMS[_row_bucket(s)] + 32 * _row_bucket(o)


def mxu_bound(nbytes: float, int_ops: float, mma_ops: float,
              swar: "tuple[float, str]") -> "tuple[float, str]":
    """Bound of an mxu kernel: the bytes, or the integer ops the function
    needs besides its product (hash, flags) plus the product's bit pairs
    at the tensor-core rate - never above the swar twin's bound for the
    same function."""
    return min(bound(nbytes, int_ops, mma_ops), swar)


def rand_words(rng, shape, device):
    import numpy as np
    import torch

    a = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(a.view(np.int32)).to(device)


def max_err(a, b) -> int:
    if a.numel() == 0:
        return 0
    return int((a.long() - b.long()).abs().max().item())


def same(got, *wants) -> int:
    """max_abs_err of the tuple ``got`` against each of ``wants``, at
    least 1 where any tensor differs."""
    import torch

    e = max(max_err(a, b) for want in wants for a, b in zip(got, want))
    if e or not all(torch.equal(a, b) for want in wants
                    for a, b in zip(got, want)):
        return max(e, 1)
    return 0


# heal's loss (shards 1, 3 of data and 10, 12 of parity) and the other
# survivor patterns the heal kernels are checked over
LOST = (0, 2, 9, 11)
PATTERNS = {
    "data+parity missing": tuple(i not in LOST for i in range(N)),
    "parity missing": tuple(i < K for i in range(N)),
    "all present": (True,) * N,
}


def k7_recon_matrix():
    """The rows of EC 8+4's reconstruction matrix that rebuild data shards
    0-3 when those four are lost: a dense (4, 8) matrix, K7's second
    shape beside the parity matrix."""
    from minio_tpu_torch.ops import gf

    present = tuple(i for i in range(N) if i >= 4)
    return gf.reconstruction_matrix(K, M, present)[:4]


def survivor_patterns(n: int, m: int):
    """Every present mask of n rows with 0 .. m rows absent."""
    import itertools

    for lost in range(m + 1):
        for gone in itertools.combinations(range(n), lost):
            yield tuple(i not in gone for i in range(n))


def vr_pattern_sweep(dev, rng, formulation: str) -> int:
    """K6 (of ``formulation``) against its plain version and K4 (the same
    formulation) for every EC 8+4 survivor pattern with 0-4 rows absent,
    three of EC 12+4 and every one of EC 4+2, at w = 4,104 and B = 1, 2;
    returns the max_abs_err (0)."""
    import torch

    from minio_tpu_torch.ops import kernels

    err = 0
    w = 4104
    # every EC 8+4 pattern, then the other row buckets: EC 12+4 (16 rows
    # staged, the widest ring) and EC 4+2
    sets = [(K, N, list(survivor_patterns(N, M)))]
    sets.append((12, 16, [(True,) * 16, tuple(i != 0 for i in range(16)),
                          tuple(i not in (0, 5, 13, 15) for i in range(16))]))
    sets.append((4, 6, list(survivor_patterns(6, 2))))
    for k, n, patterns in sets:
        for B in (1, 2):
            x = rand_words(rng, (B, n, w), dev)
            for pres in patterns:
                got = kernels.verify_reconstruct_pipelined(x, pres, k, 4 * w, formulation)
                k4 = kernels.verify_reconstruct(x, pres, k, 4 * w, formulation)
                want = kernels.verify_reconstruct_pipelined_plain(x, pres, k, 4 * w)
                e = same(got, want, k4)
                if e:
                    fail(f"verify_reconstruct_pipelined ({formulation}) differs from "
                         f"its plain version or K4 at k={k}, B={B}, present={pres}")
                err = max(err, e)
    return err


# K4 [mxu] and K6 [mxu] off EC 8+4's buckets: (k, n, absent rows) with 1 to
# 8 rebuilt rows (the 8-row bucket of the product from 5 on), 4 tile slots,
# k = 1 and k = 12
VR_MXU_GEOMETRIES = [(8, 16, (0, 1, 2, 3, 4)), (8, 16, tuple(range(8))),
                     (5, 10, (0, 2, 4)), (2, 4, (0,)), (1, 2, (0,)),
                     (12, 16, (1, 2, 3, 4))]


def vr_mxu_sweep(dev, rng, fn) -> int:
    """K4 [mxu] or K6 [mxu] (``fn``: verify_reconstruct or
    verify_reconstruct_pipelined) against its plain version, K4 swar and
    (K6) K4 [mxu] at every geometry of VR_MXU_GEOMETRIES, at w = 4,104 and
    B = 1, 2, and (K4, whose staging loads take it) on a view off 16-byte
    alignment (4-byte loads); returns the max_abs_err (0)."""
    from minio_tpu_torch.ops import kernels

    err = 0
    w = 4104
    k4 = fn is kernels.verify_reconstruct
    for k, n, gone in VR_MXU_GEOMETRIES:
        pres = tuple(i not in gone for i in range(n))
        xs = [rand_words(rng, (1, n, w), dev), rand_words(rng, (2, n, w), dev)]
        if k4:
            xs.append(rand_words(rng, (2 * n * w + 1,), dev)[1:].view(2, n, w))
        for x in xs:
            got = fn(x, pres, k, 4 * w, "mxu")
            wants = [kernels.verify_reconstruct_plain(x, pres, k, 4 * w, "mxu"),
                     kernels.verify_reconstruct(x, pres, k, 4 * w)]
            if not k4:
                wants.append(kernels.verify_reconstruct(x, pres, k, 4 * w, "mxu"))
            e = same(got, *wants)
            if e:
                fail(f"{fn.__name__}[mxu] differs from its plain version, K4 or K4 [mxu] "
                     f"at k={k}, n={n}, absent {gone}, B={x.shape[0]}, "
                     f"offset {x.storage_offset()}")
            err = max(err, e)
    return err


# one (k, m) in each (k, m) row bucket K1's entry takes (the masked
# Horner form), m = 0, EC 8+4 (the fixed product), EC 12+4 and 4+2
K1_GEOMETRIES = [(3, 2), (4, 6), (2, 12), (6, 3), (8, 8), (5, 11), (13, 3),
                 (10, 6), (16, 16), (4, 0), (8, 4), (12, 4), (4, 2)]


def encode_geometry_sweep(dev, rng) -> int:
    """K1 and K1 [mxu] at every geometry of K1_GEOMETRIES, with and without
    the pack leg, against its plain version and (m >= 1) K5 and K5 [mxu];
    returns the max_abs_err (0)."""
    from minio_tpu_torch.ops import kernels

    err = 0
    w = 4096
    for k, m in K1_GEOMETRIES:
        x = rand_words(rng, (2, k, w), dev)
        x[1, :, 256:1024] = 0  # zero groups for the pack leg
        for group in ((0, 256) if m else (0,)):
            got = kernels.encode_pack(x, m, 4 * w, group)
            wants = [kernels.encode_pack_plain(x, m, 4 * w, group)]
            if m:
                wants.append(kernels.encode_pack_pipelined(x, m, 4 * w, group))
                wants.append(kernels.encode_pack_pipelined(x, m, 4 * w, group, "mxu"))
            e = max(same(got, *wants),
                    same(kernels.encode_pack(x, m, 4 * w, group, "mxu"), *wants))
            if e:
                fail(f"encode_pack or encode_pack[mxu] differs from its plain version, "
                     f"K5 or K5 [mxu] at k={k}, m={m}, group={group}")
            err = max(err, e)
    return err


def gf_cases(rng):
    """K3's matrices: every EC 8+4 survivor pattern with 0-4 rows absent
    and every EC 4+2 one (the reconstruction matrix over the first k
    present rows), then non-square and edge ones: one output row, 16
    outputs over 16 inputs, input rows picked out of order, an output row
    that repeats another's unit row, a zero row.  Yields (label, matrix,
    rows, R)."""
    import numpy as np

    from minio_tpu_torch.ops import gf

    for k, m in ((K, M), (4, 2)):
        for pres in survivor_patterns(k + m, m):
            idx = tuple(i for i, p in enumerate(pres) if p)[:k]
            yield f"EC {k}+{m} {pres}", gf.reconstruction_matrix(k, m, idx), idx, k + m
    pm = gf.parity_matrix(K, M)
    yield "o=1", pm[:1], tuple(range(K)), N
    yield "o=16, s=16", gf.parity_matrix(16, 16), tuple(range(16)), 16
    yield "rows out of order", pm, (11, 3, 0, 7, 5, 9, 1, 4), N
    dup = np.zeros((5, 3), dtype=np.uint8)
    dup[0, 1] = dup[2, 1] = dup[3, 0] = 1  # rows 0 and 2 copy input 1
    dup[1] = rng.integers(1, 256, 3)  # row 4 stays zero
    yield "repeated unit row, zero row", dup, (2, 0, 1), 3


def gf_pattern_sweep(dev, rng) -> int:
    """K3 against its plain version for every matrix of gf_cases at w =
    4,104 and B = 1, 2, and at a width off the 4-word quad and on a view
    off 16-byte alignment (4-byte loads); returns the max_abs_err (0)."""
    from minio_tpu_torch.ops import kernels, rs

    err = 0
    for label, mat, rows, R in gf_cases(rng):
        for B, w in ((1, 4104), (2, 4104), (2, 4101)):
            x = rand_words(rng, (B, R, w), dev)
            got = kernels.gf_matmul_words(mat, x, rows)
            e = same((got,), (rs.gf_matmul_words(mat, x, rows),))
            if e:
                fail(f"gf_matmul_words differs from its plain version at {label}, B={B}, w={w}")
            err = max(err, e)
        x = rand_words(rng, (2 * R * 4104 + 1,), dev)[1:].view(2, R, 4104)
        got = kernels.gf_matmul_words(mat, x, rows)
        e = same((got,), (rs.gf_matmul_words(mat, x, rows),))
        if e:
            fail(f"gf_matmul_words differs from its plain version on an unaligned view at {label}")
        err = max(err, e)
    return err


def check_kernels(dev, rng) -> dict:
    """Phase 2: each kernel against its plain version, then timings."""
    import numpy as np
    import torch

    from minio_tpu_torch.ops import gf, hash as phash, kernels, rs

    results = {}
    pm = gf.parity_matrix(K, M)
    # --- K1 encode_pack -------------------------------------------------
    err = 0
    # main-path shards; the 4 MiB tail block of a 64 MiB object
    # (131,072 words); the 17-byte tail of the 10 MiB + 17 object (8
    # words, no pack leg); a ragged width off the 256-word tile
    shapes = [(1, W, 256), (4, W, 256), (8, W, 256), (2, 131072, 256),
              (1, 8, 0), (2, 4104, 0)]
    for B, w, group in shapes:
        x = rand_words(rng, (B, K, w), dev)
        x[0, :, : min(w, 64)] = -1  # 0xFFFFFFFF words
        if w >= 4096:
            x[-1, :, 256:2048] = 0  # zero groups for the pack leg
        got = kernels.encode_pack(x, M, 4 * w, group)
        torch.cuda.synchronize()
        want = kernels.encode_pack_plain(x, M, 4 * w, group)
        e = max(max_err(a, b) for a, b in zip(got, want))
        if e or not all(torch.equal(a, b) for a, b in zip(got, want)):
            fail(f"encode_pack differs from its plain version at {B, w, group}")
        err = max(err, e)
    # the repo's numpy references on a small input
    x = rand_words(rng, (1, K, 1024), dev)
    par, dig, _f, _p = kernels.encode_pack(x, M, 4096, 256)
    xn = x.cpu().numpy().view(np.uint32)[0]
    ref_par = gf.encode_ref(xn.view(np.uint8).reshape(K, -1), M)
    if not np.array_equal(par.cpu().numpy().view(np.uint8)[0].reshape(M, -1), ref_par):
        fail("encode_pack parity differs from gf.encode_ref")
    allw = np.concatenate([xn, ref_par.view(np.uint32).reshape(M, -1)])
    if not np.array_equal(
        dig.cpu().numpy().view(np.uint32)[0],
        phash.phash256_host_batched(allw, 4096),
    ):
        fail("encode_pack digests differ from phash256_host_batched")
    err = max(err, encode_geometry_sweep(dev, rng))
    B = 4
    x = rand_words(rng, (B, K, W), dev)
    ms = cuda_ms(lambda: kernels.encode_pack(x, M, 4 * W, 256), 20)
    plain_ms = cuda_ms(lambda: kernels.encode_pack_plain(x, M, 4 * W, 256), 3, 1)
    g = W // 256
    nbytes = 4 * (B * K * W + 2 * B * M * W + B * M * g + B * N * 8)
    ops = B * W * (_KEY + N * _HASH + gf_ops(pm) + M)
    bms, by = bound(nbytes, ops)
    results["encode_pack"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, shape=[B, K, W],
        **device_times(lambda: kernels.encode_pack(x, M, 4 * W, 256)),
    )
    # one stripe of one tile without the pack leg: the launch's fixed chain
    # (memset, launch, fold, atomics, ticket, finalize)
    x = rand_words(rng, (1, K, 256), dev)
    results["encode_pack"]["one_tile"] = device_times(
        lambda: kernels.encode_pack(x, M, 1024, 0))

    # --- K2 phash256_batched ---------------------------------------------
    err = 0
    # the main path's shapes, then row counts off the 4-row group and
    # widths off the 1,024-word tile (and a view off 16-byte alignment)
    cases = [(32, W), (8, W), (3, 8), (12, 4104), (16, 131072)] + [
        (R, w) for R in (1, 3, 33) for w in (4, 8, 4104, 131076)
    ]
    for R, w in cases:
        x = rand_words(rng, (R, w), dev)
        got = kernels.phash256_batched(x, 4 * w)
        torch.cuda.synchronize()
        want = phash.phash256_words_batched(x, 4 * w)
        e = max_err(got, want)
        if e or not torch.equal(got, want):
            fail(f"phash256_batched differs from its plain version at {R, w}")
        err = max(err, e)
    x = rand_words(rng, (3 * 4104 + 1,), dev)[1:].view(3, 4104)  # 4-byte aligned
    got = kernels.phash256_batched(x, 4 * 4104)
    e = same((got,), (phash.phash256_words_batched(x, 4 * 4104),))
    if e:
        fail("phash256_batched differs from its plain version on an unaligned view")
    x = rand_words(rng, (5, 1000), dev)
    if not np.array_equal(
        kernels.phash256_batched(x, 4000).cpu().numpy().view(np.uint32),
        phash.phash256_host_batched(x.cpu().numpy().view(np.uint32), 4000),
    ):
        fail("phash256_batched differs from phash256_host_batched")
    R = 4 * K  # a healthy GET verifies k shards of 4 blocks per batch
    x = rand_words(rng, (R, W), dev)
    ms = cuda_ms(lambda: kernels.phash256_batched(x, 4 * W), 20)
    plain_ms = cuda_ms(lambda: phash.phash256_words_batched(x, 4 * W), 3, 1)
    # the key depends only on the column: the function needs it once per
    # column, not once per row (W * _KEY + R * W * _HASH)
    bms, by = bound(4 * (R * W + R * 8), W * _KEY + R * W * _HASH)
    results["phash256_batched"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, shape=[R, W],
        **device_times(lambda: kernels.phash256_batched(x, 4 * W)),
    )
    # one row of 4 words: the launch's fixed chain
    x = rand_words(rng, (1, 4), dev)
    results["phash256_batched"]["one_quad"] = device_times(
        lambda: kernels.phash256_batched(x, 16))

    # --- K3 gf_matmul_words ---------------------------------------------
    present = tuple(i not in (0, 2, 9, 11) for i in range(N))
    rows = tuple(i for i, p in enumerate(present) if p)[:K]
    rm = gf.reconstruction_matrix(K, M, rows)
    err = 0
    for B, w in [(1, W), (4, W), (8, W), (1, 8), (2, 4104), (2, 131072)]:
        x = rand_words(rng, (B, N, w), dev)
        got = kernels.gf_matmul_words(rm, x, rows)
        torch.cuda.synchronize()
        want = rs.gf_matmul_words(rm, x, rows)
        e = max_err(got, want)
        if e or not torch.equal(got, want):
            fail(f"gf_matmul_words differs from its plain version at {B, w}")
        err = max(err, e)
    # reconstruct really inverts the encode: rebuild the data rows
    data = rand_words(rng, (2, K, 4104), dev)
    par = kernels.encode_pack(data, M, 4 * 4104, 0)[0]
    full = torch.cat([data, par], dim=1).contiguous()
    if not torch.equal(kernels.gf_matmul_words(rm, full, rows), data):
        fail("gf_matmul_words does not rebuild the data rows")
    err = max(err, gf_pattern_sweep(dev, rng))
    B = 4
    x = rand_words(rng, (B, N, W), dev)
    ms = cuda_ms(lambda: kernels.gf_matmul_words(rm, x, rows), 20)
    plain_ms = cuda_ms(lambda: rs.gf_matmul_words(rm, x, rows), 3, 1)
    bms, by = bound(4 * (B * K * W + B * K * W), B * W * gf_ops(rm))
    results["gf_matmul_words"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, shape=[B, N, W],
        **device_times(lambda: kernels.gf_matmul_words(rm, x, rows)),
    )
    x = rand_words(rng, (1, N, 256), dev)
    results["gf_matmul_words"]["one_tile"] = device_times(
        lambda: kernels.gf_matmul_words(rm, x, rows))
    return results


def check_heal_kernels(dev, rng) -> dict:
    """Phase 2, heal: verify_reconstruct (K4) and encode_pack without
    the pack leg (the P2 function) against their plain versions, then
    timings at heal's shapes."""
    import numpy as np
    import torch

    from minio_tpu_torch.codec.backend import TorchBackend
    from minio_tpu_torch.ops import codec_step, gf, hash as phash, kernels

    results = {}
    # --- K4 verify_reconstruct ------------------------------------------
    err = 0
    for B, w in [(1, W), (4, W), (1, 131072), (1, 8), (2, 4104)]:
        x = rand_words(rng, (B, N, w), dev)
        host = x.cpu().numpy().view(np.uint32)
        for pname, pres in PATTERNS.items():
            got = kernels.verify_reconstruct(x, pres, K, 4 * w)
            torch.cuda.synchronize()
            want = kernels.verify_reconstruct_plain(x, pres, K, 4 * w)
            e = max(max_err(a, b) for a, b in zip(got, want))
            if e or not all(torch.equal(a, b) for a, b in zip(got, want)):
                fail(f"verify_reconstruct differs from its plain version at {B, w}, {pname}")
            err = max(err, e)
            rows = tuple(i for i, p in enumerate(pres) if p)[:K]
            rm = gf.reconstruction_matrix(K, M, rows)
            if not torch.equal(got[0], kernels.gf_matmul_words(rm, x, rows)):
                fail(f"verify_reconstruct data differs from gf_matmul_words at {B, w}, {pname}")
            live = [i for i, p in enumerate(pres) if p]
            if not np.array_equal(
                got[1].cpu().numpy().view(np.uint32)[:, live],
                phash.phash256_host_batched(host[:, live], 4 * w),
            ):
                fail(f"verify_reconstruct digests differ from phash256_host_batched at {B, w}, {pname}")
    # the staging's 4-byte loads: a view off 16-byte alignment
    x = rand_words(rng, (2 * N * 4104 + 1,), dev)[1:].view(2, N, 4104)
    for pname, pres in PATTERNS.items():
        e = same(kernels.verify_reconstruct(x, pres, K, 4 * 4104),
                 kernels.verify_reconstruct_plain(x, pres, K, 4 * 4104))
        if e:
            fail(f"verify_reconstruct differs from its plain version on an unaligned view, {pname}")
        err = max(err, e)
    # it rebuilds what encode_pack encoded (absent rows hold garbage);
    # with all rows present and a chosen survivor bitrotted, ok flags it
    # and the backend's escalation still returns the data
    be = TorchBackend(dev)
    for B, w in [(1, W), (2, 4104)]:
        data = rand_words(rng, (B, K, w), dev)
        par, dig, _f, _p = kernels.encode_pack(data, M, 4 * w, 0)
        full = torch.cat([data, par], dim=1)
        pres = PATTERNS["data+parity missing"]
        damaged = full.clone()
        damaged[:, list(LOST)] = rand_words(rng, (B, len(LOST), w), dev)
        got, ok = codec_step.verify_and_reconstruct_words(
            damaged, dig, pres, K, M, 4 * w
        )
        want_ok = torch.tensor(pres, device=dev).expand(B, N)
        if not torch.equal(got, data) or not torch.equal(ok, want_ok):
            fail(f"verify_reconstruct does not rebuild encoded data at {B, w}")
        pres = PATTERNS["all present"]
        full[B - 1, 4, w // 3] ^= 1 << 20  # row 4 is a chosen survivor
        _d, ok = codec_step.verify_and_reconstruct_words(
            full, dig, pres, K, M, 4 * w
        )
        if bool(ok[B - 1, 4]) or int(ok.sum()) != B * N - 1:
            fail(f"verify_reconstruct does not flag the bitrotted survivor at {B, w}")
        out, _ok = be.reconstruct_and_verify(
            full.cpu().numpy().view(np.uint8), dig.cpu().numpy().view(np.uint32),
            pres, K, M,
        )
        if not np.array_equal(out, data.cpu().numpy().view(np.uint8)):
            fail(f"reconstruct_and_verify escalation returned wrong data at {B, w}")
    timings = {}
    for pname, B in [("data+parity missing", 1), ("data+parity missing", 4),
                     ("all present", 1)]:
        pres = PATTERNS[pname]
        x = rand_words(rng, (B, N, W), dev)
        rows = tuple(i for i, p in enumerate(pres) if p)[:K]
        live = sum(pres)
        ms = cuda_ms(lambda: kernels.verify_reconstruct(x, pres, K, 4 * W), 20)
        plain_ms = cuda_ms(
            lambda: kernels.verify_reconstruct_plain(x, pres, K, 4 * W), 3, 1
        )
        nbytes = 4 * (B * live * W + B * K * W + B * N * 8)
        ops = B * W * (
            _KEY + live * _HASH + gf_ops(gf.reconstruction_matrix(K, M, rows))
        )
        bms, by = bound(nbytes, ops)
        timings[f"{pname}, B={B}"] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
            shape=[B, N, W], present=live,
        )
        if (pname, B) == ("data+parity missing", 1):
            timings[f"{pname}, B={B}"].update(device_times(
                lambda: kernels.verify_reconstruct(x, pres, K, 4 * W)))
    main = timings["data+parity missing, B=1"]
    results["verify_reconstruct"] = dict(max_abs_err=err, **main, timings=timings)

    # --- K1 without the pack leg: the P2 function -------------------------
    err = 0
    for B, w in [(1, W), (1, 131072), (1, 8), (2, 4104)]:
        x = rand_words(rng, (B, K, w), dev)
        got = kernels.encode_pack(x, M, 4 * w, 0)
        torch.cuda.synchronize()
        want = kernels.encode_pack_plain(x, M, 4 * w, 0)
        e = max(max_err(a, b) for a, b in zip(got, want))
        if e or not all(torch.equal(a, b) for a, b in zip(got, want)):
            fail(f"encode_pack(group=0) differs from its plain version at {B, w}")
        err = max(err, e)
    x = rand_words(rng, (1, K, W), dev)
    ms = cuda_ms(lambda: kernels.encode_pack(x, M, 4 * W, 0), 20)
    plain_ms = cuda_ms(lambda: kernels.encode_pack_plain(x, M, 4 * W, 0), 3, 1)
    bms, by = bound(
        4 * (K * W + M * W + N * 8),
        W * (_KEY + N * _HASH + gf_ops(gf.parity_matrix(K, M)) + M),
    )
    results["encode_pack[group=0]"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, shape=[1, K, W],
        **device_times(lambda: kernels.encode_pack(x, M, 4 * W, 0)),
    )
    return results


def _chain(fn, x, acc_rows: int, cw: int, *args):
    """Run a sub-chunk form over x's last axis in chunks of cw words at
    their offsets; returns (concatenated first outputs, accumulator)."""
    import torch

    B, _r, w = x.shape
    acc = torch.zeros((B, acc_rows, 8), dtype=torch.int32, device=x.device)
    offs = list(range(0, w, cw))
    outs = []
    for i, off in enumerate(offs):
        chunk = x[:, :, off:off + cw].contiguous()
        outs.append(fn(chunk, acc, off, *args, i == len(offs) - 1)[0])
    return torch.cat(outs, dim=-1), acc


def check_overlap_kernels(dev, rng) -> dict:
    """Phase 2, overlap: K5 and K6 against their plain versions and
    against K1 and K4; the sub-chunk forms of K1 and K4 chained over S
    chunks against the whole-row pass and their plain chains; timings."""
    import torch

    from minio_tpu_torch.ops import gf, kernels

    results = {}

    # --- K5 encode_pack_pipelined ----------------------------------------
    err = 0
    for B, w, group in [(4, W, 256), (1, W, 0), (1, W, 256), (2, 131072, 256),
                        (2, 4104, 0), (1, 8, 0)]:
        x = rand_words(rng, (B, K, w), dev)
        x[0, :, : min(w, 64)] = -1
        if w >= 4096:
            x[-1, :, 256:2048] = 0  # zero groups for the pack leg
        got = kernels.encode_pack_pipelined(x, M, 4 * w, group)
        k1 = kernels.encode_pack(x, M, 4 * w, group)
        torch.cuda.synchronize()
        e = same(got, kernels.encode_pack_pipelined_plain(x, M, 4 * w, group), k1)
        if e:
            fail(f"encode_pack_pipelined differs from its plain version or K1 at {B, w, group}")
        err = max(err, e)
    pm = gf.parity_matrix(K, M)
    timings = {}
    for B, group in [(4, 256), (1, 0)]:
        x = rand_words(rng, (B, K, W), dev)
        g = W // 256 if group else 0
        nbytes = 4 * (B * K * W + (2 if group else 1) * B * M * W + B * M * g + B * N * 8)
        bms, by = bound(nbytes, B * W * (_KEY + N * _HASH + gf_ops(pm) + M))
        timings[f"B={B}, group={group}"] = dict(
            ms=cuda_ms(lambda: kernels.encode_pack_pipelined(x, M, 4 * W, group), 20),
            k1_ms=cuda_ms(lambda: kernels.encode_pack(x, M, 4 * W, group), 20),
            plain_ms=cuda_ms(lambda: kernels.encode_pack_pipelined_plain(x, M, 4 * W, group), 3, 1),
            bound_ms=bms, bound_by=by, shape=[B, K, W],
        )
        if (B, group) == (4, 256):
            timings[f"B={B}, group={group}"].update(device_times(
                lambda: kernels.encode_pack_pipelined(x, M, 4 * W, group)))
    results["encode_pack_pipelined"] = dict(
        max_abs_err=err, **timings["B=4, group=256"], timings=timings
    )

    # --- K6 verify_reconstruct_pipelined ------------------------------------
    err = 0
    for B, w in [(1, W), (4, W), (1, 131072), (2, 4104), (1, 8)]:
        x = rand_words(rng, (B, N, w), dev)
        for pname, pres in PATTERNS.items():
            got = kernels.verify_reconstruct_pipelined(x, pres, K, 4 * w)
            k4 = kernels.verify_reconstruct(x, pres, K, 4 * w)
            torch.cuda.synchronize()
            e = same(got, kernels.verify_reconstruct_pipelined_plain(x, pres, K, 4 * w), k4)
            if e:
                fail(f"verify_reconstruct_pipelined differs from its plain version or K4 at {B, w}, {pname}")
            err = max(err, e)
    err = max(err, vr_pattern_sweep(dev, rng, "swar"))
    timings = {}
    for pname, B in [("data+parity missing", 1), ("data+parity missing", 4),
                     ("all present", 1)]:
        pres = PATTERNS[pname]
        x = rand_words(rng, (B, N, W), dev)
        rows = tuple(i for i, p in enumerate(pres) if p)[:K]
        live = sum(pres)
        bms, by = bound(
            4 * (B * live * W + B * K * W + B * N * 8),
            B * W * (_KEY + live * _HASH + gf_ops(gf.reconstruction_matrix(K, M, rows))),
        )
        timings[f"{pname}, B={B}"] = dict(
            ms=cuda_ms(lambda: kernels.verify_reconstruct_pipelined(x, pres, K, 4 * W), 20),
            k4_ms=cuda_ms(lambda: kernels.verify_reconstruct(x, pres, K, 4 * W), 20),
            plain_ms=cuda_ms(lambda: kernels.verify_reconstruct_pipelined_plain(x, pres, K, 4 * W), 3, 1),
            bound_ms=bms, bound_by=by, shape=[B, N, W], present=live,
            **device_times(lambda: kernels.verify_reconstruct_pipelined(x, pres, K, 4 * W)),
        )
    # one block of one tile: the launch's fixed chain (memset, staging,
    # fold, atomics, ticket, finalize) with next to no columns
    x = rand_words(rng, (1, N, 4), dev)
    pres = PATTERNS["data+parity missing"]
    timings["data+parity missing, B=1, w=4"] = device_times(
        lambda: kernels.verify_reconstruct_pipelined(x, pres, K, 16))
    results["verify_reconstruct_pipelined"] = dict(
        max_abs_err=err, **timings["data+parity missing, B=1"], timings=timings
    )

    # --- the sub-chunk forms of K1 and K4 -----------------------------------
    CW = 65536  # 256 KiB of shard bytes, the default MINIO_TPU_CODEC_SUBCHUNK_KB
    err = 0
    for B, w, cw, group in [(4, W, CW, 256), (1, W, CW - 768, 256),
                            (2, 4104, 1000, 0)]:
        x = rand_words(rng, (B, K, w), dev)
        if w >= 4096:
            x[-1, :, 256:2048] = 0
        par, acc = _chain(kernels.encode_pack_subchunk, x, N, cw, M, 4 * w, group)
        whole = kernels.encode_pack(x, M, 4 * w, 0)
        torch.cuda.synchronize()
        plain = _chain(kernels.encode_pack_subchunk_plain, x, N, cw, M, 4 * w, group)
        e = same((par, acc), whole[:2], plain)
        if e:
            fail(f"encode_pack_subchunk chain differs from the whole row or its plain chain at {B, w, cw}")
        err = max(err, e)
    B = 4
    x = rand_words(rng, (B, K, W), dev)
    chunks = [(o, x[:, :, o:o + CW].contiguous()) for o in range(0, W, CW)]

    def enc_chain(fn):
        acc = torch.zeros((B, N, 8), dtype=torch.int32, device=dev)
        for i, (o, c) in enumerate(chunks):
            fn(c, acc, o, M, 4 * W, 256, i == len(chunks) - 1)

    g = W // 256
    bms, by = bound(
        4 * (B * K * W + 2 * B * M * W + B * M * g + B * N * 8),
        B * W * (_KEY + N * _HASH + gf_ops(pm) + M),
    )
    results["encode_pack[subchunk]"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: enc_chain(kernels.encode_pack_subchunk), 20),
        plain_ms=cuda_ms(lambda: enc_chain(kernels.encode_pack_subchunk_plain), 3, 1),
        bound_ms=bms, bound_by=by, shape=[B, K, W], chunks=len(chunks),
        **device_times(lambda: enc_chain(kernels.encode_pack_subchunk)),
    )
    err = 0
    for B, w, cw in [(1, W, CW), (4, W, CW), (1, W, CW - 768), (2, 4104, 1000)]:
        x = rand_words(rng, (B, N, w), dev)
        for pname, pres in PATTERNS.items():
            data, acc = _chain(kernels.verify_reconstruct_subchunk, x, N, cw, pres, K, 4 * w)
            whole = kernels.verify_reconstruct(x, pres, K, 4 * w)
            torch.cuda.synchronize()
            plain = _chain(kernels.verify_reconstruct_subchunk_plain, x, N, cw, pres, K, 4 * w)
            e = same((data, acc), whole, plain)
            if e:
                fail(f"verify_reconstruct_subchunk chain differs from the whole row or its plain chain at {B, w, cw}, {pname}")
            err = max(err, e)
    B = 1
    pres = PATTERNS["data+parity missing"]
    x = rand_words(rng, (B, N, W), dev)
    chunks = [(o, x[:, :, o:o + CW].contiguous()) for o in range(0, W, CW)]

    def vr_chain(fn):
        acc = torch.zeros((B, N, 8), dtype=torch.int32, device=dev)
        for i, (o, c) in enumerate(chunks):
            fn(c, acc, o, pres, K, 4 * W, i == len(chunks) - 1)

    rows = tuple(i for i, p in enumerate(pres) if p)[:K]
    live = sum(pres)
    bms, by = bound(
        4 * (B * live * W + B * K * W + B * N * 8),
        B * W * (_KEY + live * _HASH + gf_ops(gf.reconstruction_matrix(K, M, rows))),
    )
    results["verify_reconstruct[subchunk]"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: vr_chain(kernels.verify_reconstruct_subchunk), 20),
        plain_ms=cuda_ms(lambda: vr_chain(kernels.verify_reconstruct_subchunk_plain), 3, 1),
        bound_ms=bms, bound_by=by, shape=[B, N, W], present=live, chunks=len(chunks),
        **device_times(lambda: vr_chain(kernels.verify_reconstruct_subchunk)),
    )
    return results


def check_k7(dev, rng) -> dict:
    """K7 gf_matmul_mxu against its plain version and K3 on the same bytes
    as words (where the bytes are whole aligned words): EC 8+4's parity,
    the reconstruction matrices of heal's pattern and of 4 lost data
    shards at the codec's (4 or 8, 8, 1,310,720), ragged and sub-tile
    lengths, views 1 and 16 bytes off alignment, a length that leaves
    blocks without a tile, and one matrix for each (output, row) bucket
    pair; then gf.encode_ref.  Times at the codec's shape beside K3's,
    one tile, and the phases (``k7_phases``)."""
    import numpy as np
    import torch

    from minio_tpu_torch.ops import gf, kernels, rs

    pm = gf.parity_matrix(K, M)
    rows = tuple(i for i, p in enumerate(PATTERNS["data+parity missing"]) if p)[:K]
    rm = gf.reconstruction_matrix(K, M, rows)
    r4 = k7_recon_matrix()
    L = BLOCK // K  # one shard of a 10 MiB block: 10 MiB over the 8 rows
    sms = kernels.sm_count(dev)
    # an (o, s) matrix for every (output, row) bucket pair of the entry
    buckets = [(o, s_) for o in (1, 5, 16) for s_ in (3, 8, 13)]
    edge = np.random.default_rng(SEED + 7)
    cases = [(pm, L, 0), (rm, L, 0), (r4, L, 0), (pm, 8192 + 17, 0), (rm, 4104 * 4 + 3, 0),
             (gf.parity_matrix(16, 16), 4096, 0), (pm[:1, :1], 5, 0), (pm, 1000, 0),
             (pm, 1024, 0), (pm, 1040, 0), (r4, 64 * 1024 + 8, 0),
             # a view 1 and 16 bytes into its storage
             (pm, 8192, 1), (r4, 65536 + 48, 16),
             # blocks past the last tile: 1,281 tiles on 264 blocks of 5
             (pm, L + 1024, 0)]
    cases += [(edge.integers(0, 256, (o, s_)).astype(np.uint8), 3 * 1024 + 80, 0)
              for o, s_ in buckets]
    err = 0
    for mat, length, off in cases:
        o, s_ = mat.shape
        base = torch.from_numpy(rng.integers(0, 256, (s_ * length + off,), dtype=np.uint8)).to(dev)
        sh = base[off:].view(s_, length)
        blocks, tpb = kernels.k7_grid(length, sms, o, s_)
        if (length, off) == (L + 1024, 0) and blocks * tpb - -(-length // 1024) < tpb:
            fail("gf_matmul_mxu sweep: the idle-block case leaves no block idle")
        got = kernels.gf_matmul_mxu(mat, sh)
        torch.cuda.synchronize()
        e = same((got,), (rs.gf_matmul_mxu_plain(mat, sh),))
        if length % 4 == 0 and off % 4 == 0:  # the swar twin: K3 on the same bytes as words
            words = sh.view(torch.int32)[None]
            twin = kernels.gf_matmul_words(mat, words, tuple(range(s_)))
            e = max(e, same((got,), (twin[0].contiguous().view(torch.uint8),)))
        if e:
            fail(f"gf_matmul_mxu differs from its plain version or K3 at "
                 f"{o, s_, length} offset {off}")
        err = max(err, e)
    x = torch.from_numpy(rng.integers(0, 256, (8, 64), dtype=np.uint8)).to(dev)
    if not np.array_equal(kernels.gf_matmul_mxu(pm, x).cpu().numpy(),
                          gf.encode_ref(x.cpu().numpy(), M)):
        fail("gf_matmul_mxu differs from gf.encode_ref")
    sh = torch.from_numpy(rng.integers(0, 256, (K, L), dtype=np.uint8)).to(dev)
    if not np.array_equal(kernels.gf_matmul_mxu(pm, sh).cpu().numpy(),
                          gf.encode_ref(sh.cpu().numpy(), M)):
        fail("gf_matmul_mxu differs from gf.encode_ref at the main shape")
    words = sh.view(torch.int32)[None]
    bms, by = mxu_bound((K + M) * L, 0, L // 4 * mxu_ops(M, K),
                        bound((K + M) * L, L // 4 * gf_ops(pm)))
    one = sh[:, :1024].contiguous()
    return dict(
        max_abs_err=err, ms=cuda_ms(lambda: kernels.gf_matmul_mxu(pm, sh), 20),
        swar_ms=cuda_ms(lambda: kernels.gf_matmul_words(pm, words, tuple(range(K))), 20),
        plain_ms=cuda_ms(lambda: rs.gf_matmul_mxu_plain(pm, sh), 3, 1),
        bound_ms=bms, bound_by=by, shape=[M, K, L],
        design_int_ops=L // 4 * k7_design_ops(M, K),
        one_tile_device_ms=device_times(lambda: kernels.gf_matmul_mxu(pm, one))["device_ms"],
        phases=k7_phases(kernels, pm, sh),
        **device_times(lambda: kernels.gf_matmul_mxu(pm, sh)),
    )


def check_mxu_kernels(dev, rng) -> dict:
    """Phase 2, mxu: K7 gf_matmul_mxu and the mxu instantiations of K1,
    K4, K5 and K6 against their plain versions (rs.mxu_rows) and their
    swar twins (K3 for K7), then timings beside the twins'."""
    import numpy as np
    import torch

    from minio_tpu_torch.ops import gf, kernels, rs

    results = {}

    results["gf_matmul_mxu"] = check_k7(dev, rng)
    pm = gf.parity_matrix(K, M)

    # --- K1 and K5 [mxu] ----------------------------------------------------
    for name, fn, plain in [
        ("encode_pack", kernels.encode_pack, kernels.encode_pack_plain),
        ("encode_pack_pipelined", kernels.encode_pack_pipelined,
         kernels.encode_pack_pipelined_plain),
    ]:
        err = 0
        for B, w, group in [(4, W, 256), (1, W, 0), (2, 131072, 256),
                            (2, 4104, 0), (1, 8, 0)]:
            x = rand_words(rng, (B, K, w), dev)
            x[0, :, : min(w, 64)] = -1
            if w >= 4096:
                x[-1, :, 256:2048] = 0  # zero groups for the pack leg
            got = fn(x, M, 4 * w, group, formulation="mxu")
            twin = fn(x, M, 4 * w, group)
            torch.cuda.synchronize()
            wants = [plain(x, M, 4 * w, group, "mxu"), twin]
            if name == "encode_pack_pipelined":
                wants.append(kernels.encode_pack(x, M, 4 * w, group))  # K1
            e = same(got, *wants)
            if e:
                fail(f"{name}[mxu] differs from its plain version, swar twin or K1 "
                     f"at {B, w, group}")
            err = max(err, e)
        if name == "encode_pack":
            # K1 [mxu] off its 16-byte staging loads: a view off 16-byte
            # alignment
            x = rand_words(rng, (2 * K * 4104 + 1,), dev)[1:].view(2, K, 4104)
            e = same(fn(x, M, 4 * 4104, 0, formulation="mxu"),
                     plain(x, M, 4 * 4104, 0, "mxu"), fn(x, M, 4 * 4104, 0))
            if e:
                fail("encode_pack[mxu] differs from its plain version or swar twin "
                     "on an unaligned view")
            err = max(err, e)
        B = 4
        x = rand_words(rng, (B, K, W), dev)
        g = W // 256
        nbytes = 4 * (B * K * W + 2 * B * M * W + B * M * g + B * N * 8)
        hash_ops = B * W * (_KEY + N * _HASH + M)
        bms, by = mxu_bound(nbytes, hash_ops, B * W * mxu_ops(M, K),
                            bound(nbytes, hash_ops + B * W * gf_ops(pm)))
        results[f"{name}[mxu]"] = dict(
            max_abs_err=err,
            ms=cuda_ms(lambda: fn(x, M, 4 * W, 256, formulation="mxu"), 20),
            swar_ms=cuda_ms(lambda: fn(x, M, 4 * W, 256), 20),
            plain_ms=cuda_ms(lambda: plain(x, M, 4 * W, 256, "mxu"), 3, 1),
            bound_ms=bms, bound_by=by, shape=[B, K, W],
            # K5 [mxu] has its own product (mxu_ring_tile)
            # K1 and K5 [mxu] run mxu_ring_tile
            design_int_ops=B * W * mxu_ring_design_ops(M, K),
            **device_times(lambda: fn(x, M, 4 * W, 256, formulation="mxu")),
        )

    # --- K4 and K6 [mxu] ----------------------------------------------------
    for name, fn, plain in [
        ("verify_reconstruct", kernels.verify_reconstruct,
         kernels.verify_reconstruct_plain),
        ("verify_reconstruct_pipelined", kernels.verify_reconstruct_pipelined,
         kernels.verify_reconstruct_pipelined_plain),
    ]:
        err = 0
        for B, w in [(1, W), (4, W), (2, 4104), (1, 8)]:
            x = rand_words(rng, (B, N, w), dev)
            for pname, pres in PATTERNS.items():
                got = fn(x, pres, K, 4 * w, formulation="mxu")
                twin = fn(x, pres, K, 4 * w)
                torch.cuda.synchronize()
                e = same(got, plain(x, pres, K, 4 * w, "mxu"), twin)
                if e:
                    fail(f"{name}[mxu] differs from its plain version or swar twin at {B, w}, {pname}")
                err = max(err, e)
        if name == "verify_reconstruct_pipelined":
            err = max(err, vr_pattern_sweep(dev, rng, "mxu"))
        err = max(err, vr_mxu_sweep(dev, rng, fn))
        timings = {}
        for pname, B in [("data+parity missing", 1), ("data+parity missing", 4)]:
            pres = PATTERNS[pname]
            x = rand_words(rng, (B, N, W), dev)
            rows = tuple(i for i, p in enumerate(pres) if p)[:K]
            live = sum(pres)
            nbytes = 4 * (B * live * W + B * K * W + B * N * 8)
            hash_ops = B * W * (_KEY + live * _HASH)
            rm = gf.reconstruction_matrix(K, M, rows)
            # the product the function needs: the rebuilt rows only
            rb = len(product_rows(rm))
            mma = B * W * mxu_ops(rb, K)
            bms, by = mxu_bound(nbytes, hash_ops, mma,
                                bound(nbytes, hash_ops + B * W * gf_ops(rm)))
            timings[f"{pname}, B={B}"] = dict(
                ms=cuda_ms(lambda: fn(x, pres, K, 4 * W, formulation="mxu"), 20),
                swar_ms=cuda_ms(lambda: fn(x, pres, K, 4 * W), 20),
                plain_ms=cuda_ms(lambda: plain(x, pres, K, 4 * W, "mxu"), 3, 1),
                bound_ms=bms, bound_by=by, shape=[B, N, W], present=live,
                # K4 and K6 [mxu] multiply the rebuilt rows in mxu_ring_tile
                design_int_ops=B * W * mxu_ring_design_ops(rb, K),
            )
            if B == 1:
                timings[f"{pname}, B={B}"].update(device_times(
                    lambda: fn(x, pres, K, 4 * W, formulation="mxu")))
        results[f"{name}[mxu]"] = dict(
            max_abs_err=err, **timings["data+parity missing, B=1"], timings=timings
        )
    return results


def legacy_plane(rng, kind: str, shape, device):
    """A parity plane of u32 words for K12 and K13: ``dense`` (random, the
    main path's), ``sparse`` (random on about a third of the 256-word
    groups), ``zeros``, ``nonzero`` (one word with the high bit set in
    every group, everything else zero), ``full`` (no zero word), or
    ``first`` / ``last`` (one nonzero word in each row's first or last
    group, everything else zero)."""
    import torch

    x = rand_words(rng, shape, device)
    *lead, w = shape
    g = w // 256
    grouped = x.view(*lead, g, 256)
    if kind == "sparse":
        keep = torch.from_numpy(rng.random((*lead, g)) < 1 / 3).to(device)
        grouped.mul_(keep[..., None].to(torch.int32))
    elif kind == "full":
        x.bitwise_or_(1)
    elif kind in ("zeros", "nonzero", "first", "last"):
        x.zero_()
    if kind == "nonzero":
        at = torch.from_numpy(rng.integers(0, 256, (*lead, g, 1))).to(device)
        grouped.scatter_(-1, at, torch.full_like(at, -(1 << 31), dtype=torch.int32))
    elif kind in ("first", "last"):
        rows = x.view(-1, w)
        at = rng.integers(0, 256, rows.shape[0]) + (0 if kind == "first" else w - 256)
        rows[torch.arange(rows.shape[0]), torch.from_numpy(at)] = torch.from_numpy(
            rng.integers(1, 1 << 31, rows.shape[0]).astype("int32")
        ).to(device)
    return x


LEGACY_KINDS = ("dense", "sparse", "zeros", "nonzero", "full", "first", "last")
# planes on the edges of K13's cluster split (kernels.pack_plan): 6 rows
# of 21 groups (16-block clusters, g not a multiple), 16 of 13 (8-block
# clusters), 12 of 5 and 1 of 3 (g below the cluster), 1 row of 3,077 and
# 9 of 1,541 groups (past one cluster's shared memory at 16 and at 8
# blocks: two passes)
LEGACY_EDGES = [(2, 3, 21 * 256), (4, 4, 13 * 256), (3, 4, 5 * 256), (1, 1, 3 * 256),
                (1, 1, 3077 * 256), (3, 3, 1541 * 256)]
# K12 runs held and timed beside the plan's (kernels.group_plan): one warp
# a group, runs of 2 and 3 (a batch cut short), 8 (two batches) and 33
# (two 32-flag stores a warp)
K12_RUNS = (1, 2, 3, 8, 33)
# K12 runs timed with ``--only legacy``: at the main path's plane, 1 is
# 2,560 blocks (about 4 waves of 5 blocks an SM), 5 one wave of 512
K12_SWEEP = (1, 2, 3, 4, 5, 8)
# the bytes of distinct planes the graph-replayed device times cycle
# through: past the 50 MB L2, so no call finds its plane there
LEGACY_ROTATION_BYTES = 64 << 20


def rotation(planes: list):
    """A function that returns the next of ``planes`` at each call."""
    turn = [0]

    def nxt():
        turn[0] += 1
        return planes[turn[0] % len(planes)]
    return nxt


def legacy_planes(rng, shape, dev) -> list:
    """Dense planes of ``shape``, at least 3 and LEGACY_ROTATION_BYTES
    together."""
    nbytes = 4 * math.prod(shape)
    count = max(3, -(-LEGACY_ROTATION_BYTES // nbytes))
    return [legacy_plane(rng, "dense", shape, dev) for _ in range(count)]


def kernels_of(fn) -> "list | None":
    """The device kernels one call of ``fn`` launches, by name, from
    torch.profiler (CUPTI); None where the profiler sees no device
    activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return names or None


def check_legacy_kernels(dev, rng, design: bool = False) -> dict:
    """K12 group_flags and K13 pack_nonzero_groups (the legacy drain's
    passes, MINIO_TPU_CODEC_KERNEL=legacy) against their plain versions on
    the card: at the main path's parity plane (4, 4, 327,680), at heal's
    B = 1, ragged B and on the edges of K13's cluster split
    (``LEGACY_EDGES``), each dense, sparse, all zero, one nonzero word a
    group, no zero word, and one nonzero word in each row's first or last
    group; on views 4 bytes off 16-byte alignment (K13's thread-staged
    path, one pass and two); K12 also at runs other than its plan's
    (``K12_RUNS``: one warp a group, batches cut short, runs past one
    32-flag store); and against the flags and ``packed`` that K1's and
    K5's own pack legs emit for the same parity (what the bisection
    oracle is for).  K13 must be one count in LAUNCHES a call.  Times at
    the main path's dense plane and at heal's: events on one plane, K12
    beside ``plane.view(B, m, g, 256).any(-1)`` (the one PyTorch call of
    its function; no PyTorch call computes K13's), and the
    graph-replayed device times over a rotation of distinct planes past
    the L2 (``legacy_planes``), the cold times; K12 on one group is the
    fixed cost of a launch in each time (``one_group``).  With
    ``design`` (``--only legacy``) also: K13 must be one kernel a call by
    the profiler's count (which must see the card), and K12's times at
    each run of ``K12_SWEEP`` in two turns (``runs``)."""
    import statistics

    import torch

    from minio_tpu_torch.ops import kernels

    G = 256
    err = {"group_flags": 0, "pack_nonzero_groups": 0}

    def hold(x, what: str, runs=(None,)):
        flags = kernels.group_flags(x, G)
        got = kernels.pack_nonzero_groups(x, G)
        torch.cuda.synchronize()
        want = kernels.pack_nonzero_groups_plain(x, G)
        e = same((flags,), (want[0],))
        for run in runs[1:]:
            e = max(e, same((kernels._group_call(x, G, "group_flags", False, run)[0],),
                            (want[0],)))
        if e:
            fail(f"group_flags differs from its plain version on {what}")
        err["group_flags"] = max(err["group_flags"], e)
        e = same(got, want)
        if e:
            fail(f"pack_nonzero_groups differs from its plain version on {what}")
        err["pack_nonzero_groups"] = max(err["pack_nonzero_groups"], e)
        return flags, got

    shapes = [(4, M, W), (1, M, W), (3, M, 8192), (7, M, 2 * G), (5, 2, 3 * G),
              *LEGACY_EDGES]
    for shape in shapes:
        for kind in LEGACY_KINDS:
            hold(legacy_plane(rng, kind, shape, dev), f"{kind} {shape}",
                 (None, *K12_RUNS) if kind in ("sparse", "last") else (None,))
    for shape in ((3, M, 4096), (1, 1, 3077 * G)):
        n = math.prod(shape)
        x = legacy_plane(rng, "sparse", (n + 256,), dev)[1:1 + n].view(shape)
        hold(x, f"a view {shape} 4 bytes off alignment", (None, *K12_RUNS))
    # against K1's own pack leg: data with zeroed columns gives a parity
    # plane with zero groups, flagged and packed inside the encode launch
    data = legacy_plane(rng, "sparse", (4, K, W), dev)
    parity, _dig, k1_flags, k1_packed = kernels.encode_pack(data, M, 4 * W, G)
    flags, (pflags, packed) = hold(parity, "K1's parity")
    if same((flags, pflags, packed), (k1_flags, k1_flags, k1_packed)):
        fail("group_flags / pack_nonzero_groups differ from K1's flags and packed")
    parity, _dig, k5_flags, k5_packed = kernels.encode_pack_pipelined(
        data, M, 4 * W, G)
    flags, (pflags, packed) = hold(parity, "K5's parity")
    if same((flags, pflags, packed), (k5_flags, k5_flags, k5_packed)):
        fail("group_flags / pack_nonzero_groups differ from K5's flags and packed")

    results = {}
    # the fixed cost of one launch in each time: K12 on one group
    one = [legacy_plane(rng, "dense", (1, 1, G), dev) for _ in range(3)]
    nxt_one = rotation(one)
    fixed = device_times(lambda: kernels.group_flags(nxt_one(), G))
    for label, B in (("", 4), ("heal", 1)):
        planes = legacy_planes(rng, (B, M, W), dev)
        plane = planes[0]
        nxt = rotation(planes)
        g = W // G
        words = B * M * W
        lib, launched = {}, None
        if not label:
            # one K13 call is one count in LAUNCHES, whatever the plan (and
            # with ``design`` one kernel by the profiler's count); and the
            # library call beside K12 at the main path's plane
            kernels.reset_launches()
            kernels.pack_nonzero_groups(plane, G)
            if design:
                launched = kernels_of(lambda: kernels.pack_nonzero_groups(plane, G))
                if launched is None:
                    fail("the profiler saw no kernel of pack_nonzero_groups on the card")
                elif len(launched) != 1 or "pack_groups_kernel" not in launched[0]:
                    fail(f"pack_nonzero_groups launched {launched} in one call")
            counted = dict(kernels.LAUNCHES)
            want_count = 3 if design else 1
            if counted["pack_nonzero_groups"] != want_count or counted["group_flags"]:
                fail(f"pack_nonzero_groups counted {counted['pack_nonzero_groups']} "
                     f"launches in {want_count} calls")
            lib = device_times(lambda: nxt().view(B, M, g, G).any(-1))
        # both host-bound by events: the medians of three turns each,
        # taken in alternation
        k12_ms, lib_ms = [], []
        for _ in range(3):
            k12_ms.append(cuda_ms(lambda: kernels.group_flags(plane, G), 20))
            lib_ms.append(cuda_ms(lambda: plane.view(B, M, g, G).any(-1), 20))
        bms, by = bound(4 * (words + B * M * g), words)
        k12 = dict(
            max_abs_err=err["group_flags"], shape=[B, M, W],
            ms=statistics.median(k12_ms),
            plain_ms=cuda_ms(lambda: kernels.group_flags_plain(plane, G), 3, 1),
            library_ms=statistics.median(lib_ms),
            bound_ms=bms, bound_by=by, rotation=len(planes),
            **device_times(lambda: kernels.group_flags(nxt(), G)),
        )
        k12["run"] = kernels._group_plan(B * M * g, dev.index)
        if design:
            # runs of one group a warp (many waves) up to a persistent
            # grid (one wave of long runs): each run's device and cold
            # times in two turns, forward then backward
            k12["runs"] = {}
            for turn in range(2):
                for run in K12_SWEEP[::1 if turn == 0 else -1]:
                    call = (lambda r: lambda: kernels._group_call(
                        nxt(), G, "group_flags", False, r))(run)
                    row = k12["runs"].setdefault(
                        run, {"blocks": -(-(-(-B * M * g // run)) // 8)})
                    for key, val in device_times(call).items():
                        row.setdefault(key, []).append(val)
        if lib:
            k12["library_device_ms"] = lib["device_ms"]
            k12["library_cold_ms"] = lib["cold_ms"]
            k12["library_cold_read_ms"] = lib["cold_read_ms"]
        bms, by = bound(4 * (2 * words + B * M * g), words)
        k13 = dict(
            max_abs_err=err["pack_nonzero_groups"], shape=[B, M, W],
            ms=cuda_ms(lambda: kernels.pack_nonzero_groups(plane, G), 20),
            plain_ms=cuda_ms(lambda: kernels.pack_nonzero_groups_plain(plane, G), 3, 1),
            library_ms=None, bound_ms=bms, bound_by=by, rotation=len(planes),
            **device_times(lambda: kernels.pack_nonzero_groups(nxt(), G)),
        )
        # K13's plan (cluster, seg, passes), how many clusters of that
        # split the card holds at once, and of the one-pass split
        k13["plan"] = kernels._pack_plan(B * M, W, dev.index)
        lib13 = kernels._load()
        k13["resident"] = lib13.mtt_pack_clusters(dev.index, *k13["plan"][:2])
        k13["resident_one_pass"] = lib13.mtt_pack_clusters(
            dev.index, k13["plan"][0], kernels.pack_split(g, k13["plan"][0])[0])
        if label:
            results["group_flags"][label] = k12
            results["pack_nonzero_groups"][label] = k13
        else:
            results["group_flags"], results["pack_nonzero_groups"] = k12, k13
            k13["kernels_a_call"] = launched
    results["group_flags"]["one_group"] = fixed
    return results


def compare_legacy_copies(dev, mods: dict, order: list) -> list:
    """K12 and K13 of several copies of the port (``mods``: name -> kernels
    module) in turns (``order``), at the main path's dense plane (4, 4,
    327,680) and heal's (1, 4, 327,680): each result first held bit for
    bit against the plain version, then cuda_ms on one plane and
    device_times over a rotation of distinct planes past the L2."""
    import numpy as np
    import torch

    rows = []
    for turn, name in enumerate(order):
        kern = mods[name]
        rng = np.random.default_rng(SEED)
        for B in (4, 1):
            planes = legacy_planes(rng, (B, M, W), dev)
            nxt = rotation(planes)
            for fn in ("group_flags", "pack_nonzero_groups"):
                call = getattr(kern, fn)
                got = call(planes[0], 256)
                got = got if isinstance(got, tuple) else (got,)
                want = kern.pack_nonzero_groups_plain(planes[0], 256)
                if same(got, want[:len(got)]):
                    fail(f"{fn} of copy {name} differs from its plain version")
                rows.append({
                    "turn": turn, "copy": name, "case": f"{fn} ({B}, {M}, {W})",
                    "events_ms": cuda_ms(lambda: call(planes[0], 256), 20, 3),
                    "rotation": len(planes),
                    **device_times(lambda: call(nxt(), 256))})
        torch.cuda.synchronize()
    return rows


def k7_phases(kern, matrix, shards) -> "dict | None":
    """K7's clock64 phases per block, from one call of a copy whose
    ``gf_matmul_mxu`` takes ``stamps``: each block's thread 0 writes its
    cycles before its first tile (setup), waiting for input (load), in
    the product and in the stores, its %globaltimer at start and end and
    its SM.  Returns the median and the
    largest of each phase over the blocks that ran a tile, the launch's
    span (first start to last end) and the spread of the blocks' starts,
    in ns; None for a copy without stamps."""
    import inspect
    import statistics

    import torch

    if "stamps" not in inspect.signature(kern.gf_matmul_mxu).parameters:
        return None
    rows = -(-shards.shape[1] // 1024)  # at most one block a 1,024-byte tile
    stamps = torch.zeros((rows, 7), dtype=torch.int64, device=shards.device)
    kern.gf_matmul_mxu(matrix, shards)  # warm
    kern.gf_matmul_mxu(matrix, shards, stamps=stamps)
    torch.cuda.synchronize()
    st = stamps.cpu().numpy()
    st = st[st[:, 4] > 0]
    out = {"blocks": int(st.shape[0]), "sms": int(len(set(st[:, 6].tolist())))}
    for i, name in enumerate(("setup", "load", "product", "store")):
        out[f"{name}_cycles_median"] = float(statistics.median(st[:, i].tolist()))
        out[f"{name}_cycles_max"] = int(st[:, i].max())
    out["span_ns"] = int(st[:, 5].max() - st[:, 4].min())
    out["start_spread_ns"] = int(st[:, 4].max() - st[:, 4].min())
    out["block_ns_median"] = float(statistics.median((st[:, 5] - st[:, 4]).tolist()))
    return out


def transfer_ms(dev) -> dict:
    """Host<->device copies of one main-path batch: 4 blocks of data in,
    4 parity planes out, from pageable memory as the serialized paths
    copy and from pinned memory as the async chain's staging does."""
    import numpy as np
    import torch

    host = np.random.default_rng(SEED).integers(
        0, 1 << 31, (4, K, W), dtype=np.int32
    )
    t = torch.from_numpy(host)
    out = {}
    out["h2d_ms"] = cuda_ms(lambda: t.to(dev), 5, 1)
    pinned = t.pin_memory()  # the async chain's staging is pinned
    out["h2d_pinned_ms"] = cuda_ms(lambda: pinned.to(dev, non_blocking=True), 5, 1)
    out["h2d_bytes"] = host.nbytes
    par = torch.zeros((4, M, W), dtype=torch.int32, device=dev)
    out["d2h_ms"] = cuda_ms(lambda: par.cpu(), 5, 1)
    back = torch.empty(par.shape, dtype=torch.int32, pin_memory=True)
    out["d2h_pinned_ms"] = cuda_ms(lambda: back.copy_(par, non_blocking=True), 5, 1)
    out["d2h_bytes"] = par.numel() * 4
    return out


def part_path(root: str, bucket: str, name: str) -> str:
    from minio_tpu_torch.storage.xl import XLStorage

    fi = XLStorage(root).read_version(bucket, name)
    return os.path.join(root, bucket, name, fi.data_dir, "part.1")


def part_files(root: str, bucket: str, name: str) -> "bytes | None":
    try:
        path = part_path(root, bucket, name)
    except Exception:  # noqa: BLE001 - disk lacks the object
        return None
    with open(path, "rb") as f:
        return f.read()


def object_files(roots: list, name: str) -> list:
    """Per disk: (part.1 bytes, xl.meta without its mod time, data dir
    and version id), or None where the disk lacks the object."""
    from minio_tpu_torch.storage.meta import XLMeta

    out = []
    for r in roots:
        part = part_files(r, "bench", name)
        if part is None:
            out.append(None)
            continue
        with open(os.path.join(r, "bench", name, "xl.meta"), "rb") as f:
            docs = [v.to_dict() for v in XLMeta.from_bytes(f.read()).versions]
        for d in docs:
            for volatile in ("mod_time_ns", "data_dir", "version_id"):
                d.pop(volatile)
        out.append((part, docs))
    return out


def main_path(dev, work: str) -> dict:
    """Phase 3: PUT, healthy GET and degraded GET through the object
    layer under the default overlap mode, with the kernel launch
    counters read around the run."""
    import numpy as np

    from minio_tpu_torch.codec.backend import get_backend
    from minio_tpu_torch.codec.telemetry import KERNEL_STATS
    from minio_tpu_torch.ops.codec_step import codec_overlap_mode
    from minio_tpu_torch.objectlayer.erasure_object import (
        ErasureObjects,
        from_reference_disks,
    )
    from minio_tpu_torch.ops import kernels
    from minio_tpu_torch.storage.xl import XLStorage

    rng = np.random.default_rng(SEED)
    sizes = OBJECT_SIZES
    payloads = [rng.bytes(s) for s in sizes]
    roots = [os.path.join(work, f"disk{i}") for i in range(N)]
    ol = ErasureObjects(
        [XLStorage(r) for r in roots], parity_blocks=M, block_size=BLOCK,
        device=dev,
    )
    ol.make_bucket("bench")
    mode = codec_overlap_mode(get_backend(dev).device)
    if mode != "pipeline":
        fail(f"the default overlap mode on the card is {mode}, not pipeline")

    kernels.reset_launches()
    KERNEL_STATS.reset()
    t_put = t_get = t_deg = 0.0
    put_each, get_each = [], []
    for i, data in enumerate(payloads):
        t0 = time.monotonic()
        ol.put_object("bench", f"obj{i}", io.BytesIO(data), len(data))
        put_each.append(time.monotonic() - t0)
        t_put += put_each[-1]
    for i, data in enumerate(payloads):
        sink = io.BytesIO()
        t0 = time.monotonic()
        ol.get_object("bench", f"obj{i}", sink)
        get_each.append(time.monotonic() - t0)
        t_get += get_each[-1]
        if sink.getvalue() != data:
            fail(f"healthy GET of obj{i} differs from its source")
    # what every mode must write (phase 5), taken before heal damages it
    written = {name: object_files(roots, name) for name in MODE_OBJECTS}
    for i, data in enumerate(payloads):
        dist = XLStorage(roots[0]).read_version("bench", f"obj{i}").erasure.distribution
        # offline: the disks holding shards 1 and 3 (data) and 10, 12
        dead = {d for d in range(N) if dist[d] in (1, 3, 10, 12)}
        degraded = from_reference_disks(
            [None if d in dead else r for d, r in enumerate(roots)],
            parity_blocks=M, block_size=BLOCK, device=dev,
        )
        sink = io.BytesIO()
        t0 = time.monotonic()
        info = degraded.get_object("bench", f"obj{i}", sink)
        t_deg += time.monotonic() - t0
        if sink.getvalue() != data:
            fail(f"degraded GET of obj{i} differs from its source")
        if info.user_defined.get("x-internal-heal-required") != "true":
            fail(f"degraded GET of obj{i} did not flag heal")
    launches = dict(kernels.LAUNCHES)
    stats = KERNEL_STATS.snapshot()
    for name in ("encode_pack_pipelined", "phash256_batched", "gf_matmul_words"):
        if launches[name] <= 0:
            fail(f"kernel {name} never launched on the main path")
    if launches["encode_pack"] != launches["encode_pack[group=0]"]:
        fail("K1 with the pack leg launched on the main path under pipeline")
    if stats["overlap_windows"]["put"] <= 0:
        fail("the main path's PUT counted no pipelined overlap windows")

    # the same port on the CPU writes the same shard files
    cpu_roots = [os.path.join(work, f"cpu{i}") for i in range(N)]
    cpu_ol = ErasureObjects(
        [XLStorage(r) for r in cpu_roots], parity_blocks=M, block_size=BLOCK,
        device="cpu",
    )
    cpu_ol.make_bucket("bench")
    cpu_ol.put_object("bench", "obj4", io.BytesIO(payloads[4]), sizes[4])
    for r_dev, r_cpu in zip(roots, cpu_roots):
        a = part_files(r_dev, "bench", "obj4")
        if a is None or a != part_files(r_cpu, "bench", "obj4"):
            fail("obj4 part files differ between device=cuda and device=cpu")

    total = sum(sizes)
    return payloads, written, {
        "overlap_mode": mode,
        "objects": len(sizes),
        "bytes": total,
        "put_s": t_put,
        "get_s": t_get,
        "get_degraded_s": t_deg,
        "put_each_s": put_each,
        "get_each_s": get_each,
        "put_MBps": total / t_put / 1e6,
        "get_MBps": total / t_get / 1e6,
        "get_degraded_MBps": total / t_deg / 1e6,
        "launches": launches,
        "device_passes": stats["device_passes"],
        "hedge": stats["hedge"],
        "h2d": stats["h2d"],
        "d2h": stats["d2h"],
        "overlap_windows": stats["overlap_windows"],
        "stages": stats["stages"],
    }


def heal_phase(dev, work: str, payloads: list) -> dict:
    """Phase 4: heal the main path's 5 objects on its 12 disks, with the
    kernel launch counters read around the phase."""
    from minio_tpu_torch.codec.telemetry import KERNEL_STATS
    from minio_tpu_torch.heal.background import HealQueue, HealRoutine
    from minio_tpu_torch.objectlayer.erasure_object import (
        ErasureObjects,
        from_reference_disks,
    )
    from minio_tpu_torch.ops import kernels
    from minio_tpu_torch.storage.xl import XLStorage

    roots = [os.path.join(work, f"disk{i}") for i in range(N)]
    names = [f"obj{i}" for i in range(len(payloads))]
    dists, lost, saved = {}, {}, {}
    for i, name in enumerate(names):
        dists[name] = XLStorage(roots[0]).read_version("bench", name).erasure.distribution
        # shards (1-based) to rebuild: 1, 3, 10, 12 deleted; on the last
        # object shard 2 bitrotted and 5, 9, 11 deleted
        lost[name] = (1, 3, 10, 12) if i < len(names) - 1 else (2, 5, 9, 11)
        for d in range(N):
            if dists[name][d] in lost[name]:
                with open(part_path(roots[d], "bench", name), "rb") as f:
                    saved[(name, d)] = f.read()
    for name in names:
        for d in range(N):
            shard = dists[name][d]
            if shard not in lost[name]:
                continue
            if shard == 2:
                with open(part_path(roots[d], "bench", name), "r+b") as f:
                    f.seek(32 + 1000)  # block 0 payload
                    byte = f.read(1)
                    f.seek(32 + 1000)
                    f.write(bytes([byte[0] ^ 0x5A]))
            else:
                shutil.rmtree(os.path.join(roots[d], "bench", name))

    ol = ErasureObjects(
        [XLStorage(r) for r in roots], parity_blocks=M, block_size=BLOCK,
        device=dev,
    )
    kernels.reset_launches()
    KERNEL_STATS.reset()
    t0 = time.monotonic()
    for name in names[:-1]:
        res = ol.heal_object("bench", name)
        want = sorted(s - 1 for s in lost[name])
        if res["outdated"] != want or res["healed"] != want:
            fail(f"heal_object({name}) healed {res['healed']}, want {want}")
    t_heal = time.monotonic() - t0
    # the last object through MRF: a GET flags it, the routine heals it
    queue = HealQueue()
    ol.heal_hook = queue.push_object
    routine = HealRoutine(ol, queue).start()
    try:
        sink = io.BytesIO()
        t0 = time.monotonic()
        info = ol.get_object("bench", names[-1], sink)
        if sink.getvalue() != payloads[-1]:
            fail(f"GET of damaged {names[-1]} differs from its source")
        if info.user_defined.get("x-internal-heal-required") != "true":
            fail(f"GET of damaged {names[-1]} did not flag heal")
        if not routine.drain(timeout_s=300):
            fail("the heal routine did not drain within 300 s")
        t_mrf = time.monotonic() - t0
        if (routine.healed, routine.failed) != (1, 0):
            fail(f"heal routine healed {routine.healed}, failed {routine.failed}")
    finally:
        if not routine.stop():
            fail("the heal routine did not stop")
    heal_stats = KERNEL_STATS.snapshot()
    # seconds per disk API over the phase, from the metered disks' ledgers
    disk_api_s: dict = {}
    for d in ol.disks:
        for api, row in d.api_stats().items():
            disk_api_s[api] = disk_api_s.get(api, 0.0) + row["seconds"]
    for name in names:
        for d in range(N):
            shard = dists[name][d]
            if shard not in lost[name]:
                continue
            with open(part_path(roots[d], "bench", name), "rb") as f:
                if f.read() != saved[(name, d)]:
                    fail(f"healed part.1 of {name} on disk {d} differs")
            if XLStorage(roots[d]).read_version("bench", name).erasure.index != shard:
                fail(f"healed xl.meta of {name} on disk {d} has a wrong index")
    # read each object with 4 disks offline that were not healed: the
    # healed shards carry the read
    for name, data in zip(names, payloads):
        offline = [d for d in range(N) if dists[name][d] not in lost[name]][:4]
        degraded = from_reference_disks(
            [None if d in offline else r for d, r in enumerate(roots)],
            parity_blocks=M, block_size=BLOCK, device=dev,
        )
        sink = io.BytesIO()
        degraded.get_object("bench", name, sink)
        if sink.getvalue() != data:
            fail(f"GET of {name} through its healed shards differs from its source")
    launches = dict(kernels.LAUNCHES)
    for name in ("verify_reconstruct_pipelined", "encode_pack[group=0]"):
        if launches[name] <= 0:
            fail(f"kernel {name} never launched on the heal path")
    # under pipeline, K1 runs only as heal's re-encode (the overlap knob
    # leaves encode alone) and escalation re-solves through K3, not K4
    if launches["encode_pack"] != launches["encode_pack[group=0]"]:
        fail("K1 with the pack leg launched on the heal path under pipeline")
    if launches["verify_reconstruct"]:
        fail("K4 launched on the heal path under pipeline")
    if heal_stats["overlap_windows"]["get"] <= 0:
        fail("heal counted no pipelined overlap windows")
    healed_bytes = sum(len(p) for p in payloads[:-1])
    return {
        "objects": len(names),
        "heal_object_s": t_heal,
        "heal_object_bytes": healed_bytes,
        "heal_object_MBps": healed_bytes / t_heal / 1e6,
        "mrf_get_and_heal_s": t_mrf,
        "mrf_bytes": len(payloads[-1]),
        "launches": launches,
        "device_passes": heal_stats["device_passes"],
        "h2d": heal_stats["h2d"],
        "d2h": heal_stats["d2h"],
        "overlap_windows": heal_stats["overlap_windows"],
        "stages": heal_stats["stages"],
        "disk_api_s": disk_api_s,
    }


# phases 5 and 6: one 64 MiB object and the 10 MiB + 17 B one, under an
# overlap mode and a formulation per run; the kernels each run must
# launch, and those it must not
MODE_OBJECTS = ("obj0", "obj4")
_MXU_NAMES = ("encode_pack[mxu]", "verify_reconstruct[mxu]",
              "encode_pack_pipelined[mxu]", "verify_reconstruct_pipelined[mxu]")
RUN_KERNELS = {
    ("swar", "pipeline"): (
        ("encode_pack_pipelined", "verify_reconstruct_pipelined"),
        ("verify_reconstruct", "encode_pack[subchunk]",
         "verify_reconstruct[subchunk]", *_MXU_NAMES)),
    ("swar", "off"): (
        ("encode_pack", "verify_reconstruct"),
        ("encode_pack_pipelined", "verify_reconstruct_pipelined",
         "encode_pack[subchunk]", "verify_reconstruct[subchunk]", *_MXU_NAMES)),
    ("swar", "async"): (
        ("encode_pack[subchunk]", "verify_reconstruct[subchunk]"),
        ("encode_pack_pipelined", "verify_reconstruct_pipelined", *_MXU_NAMES)),
    # under mxu only the PUT pass and heal's read pass change kernels:
    # heal's re-encode stays swar K1 without the pack leg, the degraded
    # GET K3
    ("mxu", "pipeline"): (
        ("encode_pack_pipelined[mxu]", "verify_reconstruct_pipelined[mxu]",
         "encode_pack[group=0]", "gf_matmul_words"),
        ("encode_pack_pipelined", "verify_reconstruct_pipelined",
         "verify_reconstruct", "encode_pack[mxu]", "verify_reconstruct[mxu]",
         "encode_pack[subchunk]", "verify_reconstruct[subchunk]")),
    ("mxu", "off"): (
        ("encode_pack[mxu]", "verify_reconstruct[mxu]", "encode_pack[group=0]",
         "gf_matmul_words"),
        ("encode_pack_pipelined", "verify_reconstruct_pipelined",
         "verify_reconstruct", "encode_pack_pipelined[mxu]",
         "verify_reconstruct_pipelined[mxu]", "encode_pack[subchunk]",
         "verify_reconstruct[subchunk]")),
    # MINIO_TPU_CODEC_KERNEL=legacy (under MINIO_TPU_CODEC_OVERLAP=async,
    # which it ignores): the PUT's K1 without the pack leg, the drain's
    # K12 (and K13 in the turn under MINIO_TPU_DEVICE_COMPRESS=on), heal's
    # K2 verify then K3, its re-encode K1 again; no fused pass
    ("swar", "legacy"): (
        ("encode_pack[group=0]", "group_flags", "phash256_batched",
         "gf_matmul_words"),
        ("encode_pack_pipelined", "verify_reconstruct",
         "verify_reconstruct_pipelined", "encode_pack[subchunk]",
         "verify_reconstruct[subchunk]", *_MXU_NAMES)),
}
# phase 5: every overlap mode and the legacy pass structure; phase 6:
# each formulation beside the other under the same mode
MODE_RUNS = [("swar", "pipeline"), ("swar", "off"), ("swar", "async"),
             ("swar", "legacy")]
# phase 6: the mxu pair, then swar after it (the formulation switches
# back: no [mxu] launch); a swar pipeline run would repeat phase 5's
# checks, so it is left out to keep the script's time
MXU_RUNS = [("mxu", "pipeline"), ("mxu", "off"), ("swar", "off")]


def modes_phase(dev, work: str, payloads: list, written: dict,
                runs: list) -> dict:
    """Phases 5 and 6: PUT, GET with 4 disks offline and heal_object of
    the MODE_OBJECTS on fresh disks for each (formulation, overlap mode)
    of ``runs``; part files and xl.meta against the main path's, launch
    counters per run."""
    from minio_tpu_torch.codec.telemetry import KERNEL_STATS
    from minio_tpu_torch.objectlayer.erasure_object import (
        ErasureObjects,
        from_reference_disks,
    )
    from minio_tpu_torch.ops import kernels
    from minio_tpu_torch.storage.xl import XLStorage

    data = {f"obj{i}": p for i, p in enumerate(payloads)}
    out: dict = {run: [] for run in runs}
    try:
        # each run once, to keep the script's time; legacy runs a
        # second turn: its first packs every drain, the second runs
        # under auto
        turns = [*runs, *(r for r in runs if r[1] == "legacy")]
        for formulation, mode in turns:
            os.environ["MINIO_TPU_CODEC_FORMULATION"] = formulation
            legacy = mode == "legacy"
            # legacy ignores the overlap mode: async must not take the
            # sub-chunk chain under it.  Its first turn packs every drain
            # (a dense plane under auto launches only K12)
            os.environ["MINIO_TPU_CODEC_OVERLAP"] = "async" if legacy else mode
            os.environ["MINIO_TPU_CODEC_KERNEL"] = "legacy" if legacy else "fused1"
            compress = "on" if legacy and not out[(formulation, mode)] else "auto"
            os.environ["MINIO_TPU_DEVICE_COMPRESS"] = compress
            roots = [os.path.join(work, f"{formulation}-{mode}{i}") for i in range(N)]
            ol = ErasureObjects(
                [XLStorage(r) for r in roots], parity_blocks=M,
                block_size=BLOCK, device=dev,
            )
            ol.make_bucket("bench")
            kernels.reset_launches()
            KERNEL_STATS.reset()
            t0 = time.monotonic()
            for name in MODE_OBJECTS:
                ol.put_object("bench", name, io.BytesIO(data[name]), len(data[name]))
            t_put = time.monotonic() - t0
            for name in MODE_OBJECTS:
                if object_files(roots, name) != written[name]:
                    fail(f"{formulation} {mode}: {name} part files or xl.meta differ from the main path's")
            t_get = 0.0
            for name in MODE_OBJECTS:
                dist = XLStorage(roots[0]).read_version("bench", name).erasure.distribution
                dead = {d for d in range(N) if dist[d] in (1, 3, 10, 12)}
                degraded = from_reference_disks(
                    [None if d in dead else r for d, r in enumerate(roots)],
                    parity_blocks=M, block_size=BLOCK, device=dev,
                )
                sink = io.BytesIO()
                t0 = time.monotonic()
                degraded.get_object("bench", name, sink)
                t_get += time.monotonic() - t0
                if sink.getvalue() != data[name]:
                    fail(f"{formulation} {mode}: degraded GET of {name} differs from its source")
                for d in dead:
                    shutil.rmtree(os.path.join(roots[d], "bench", name))
            t0 = time.monotonic()
            for name in MODE_OBJECTS:
                res = ol.heal_object("bench", name)
                if res["healed"] != [0, 2, 9, 11]:
                    fail(f"{formulation} {mode}: heal_object({name}) healed {res['healed']}")
            t_heal = time.monotonic() - t0
            for name in MODE_OBJECTS:
                if object_files(roots, name) != written[name]:
                    fail(f"{formulation} {mode}: healed {name} differs from the main path's")
            launches = dict(kernels.LAUNCHES)
            stats = KERNEL_STATS.snapshot()
            must, must_not = RUN_KERNELS[(formulation, mode)]
            label = f"{formulation} {mode}"
            for name in must:
                if launches[name] <= 0:
                    fail(f"{label}: kernel {name} never launched")
            for name in must_not:
                if launches[name]:
                    fail(f"{label}: kernel {name} launched")
            if (mode in ("pipeline", "legacy") or formulation == "mxu") and (
                launches["encode_pack"] != launches["encode_pack[group=0]"]
            ):
                fail(f"{label}: swar K1 with the pack leg launched")
            if legacy and (compress == "on") != (launches["pack_nonzero_groups"] > 0):
                fail(f"{label}: pack_nonzero_groups launched "
                     f"{launches['pack_nonzero_groups']} times under {compress}")
            windows = stats["overlap_windows"]
            if mode in ("pipeline", "async") and min(windows.values()) <= 0:
                fail(f"{label}: overlap windows {windows}")
            if mode in ("off", "legacy") and any(windows.values()):
                fail(f"{label}: overlap windows {windows}")
            nbytes = sum(len(data[n]) for n in MODE_OBJECTS)
            out[(formulation, mode)].append({
                "device_compress": compress,
                "bytes": nbytes, "put_s": t_put, "get_degraded_s": t_get,
                "heal_s": t_heal, "launches": launches,
                "device_passes": stats["device_passes"],
                "overlap_windows": windows, "h2d": stats["h2d"],
                "d2h": stats["d2h"],
            })
            for r in roots:
                shutil.rmtree(r, ignore_errors=True)
    finally:
        for env in ("MINIO_TPU_CODEC_OVERLAP", "MINIO_TPU_CODEC_FORMULATION",
                    "MINIO_TPU_CODEC_KERNEL", "MINIO_TPU_DEVICE_COMPRESS"):
            os.environ.pop(env, None)
    return out


# -- phase 7: the S3 front -------------------------------------------------

S3_CLIENTS = 4
S3_BIG = 64 << 20
S3_POLICY = (
    b'{"Version":"2012-10-17","Statement":[{"Effect":"Allow",'
    b'"Principal":{"AWS":["*"]},"Action":["s3:GetObject"],'
    b'"Resource":["arn:aws:s3:::bench/public/*"]}]}'
)


class S3Signer:
    """A small SigV4 client over http.client, signing with the port's
    own server/auth.py: one keep-alive connection per instance, over TLS
    verified against ``cafile`` when it is given."""

    def __init__(self, host: str, port: int, access_key="minioadmin",
                 secret_key="minioadmin", region="us-east-1",
                 cafile: "str | None" = None):
        import http.client
        import ssl

        self.host, self.port = host, port
        self.ak, self.sk, self.region = access_key, secret_key, region
        if cafile:
            self.conn = http.client.HTTPSConnection(
                host, port, timeout=600,
                context=ssl.create_default_context(cafile=cafile))
        else:
            self.conn = http.client.HTTPConnection(host, port, timeout=600)

    def _now(self) -> str:
        import datetime

        return datetime.datetime.now(datetime.timezone.utc).strftime(
            "%Y%m%dT%H%M%SZ")

    def _sign(self, method, path, query, headers, payload_hash):
        from minio_tpu_torch.server import auth

        amz_date = headers["x-amz-date"]
        signed = sorted(headers)
        qmap = {k: [v] for k, v in (query or {}).items()}
        sig = auth.sign_v4(method, path, qmap, headers, signed, payload_hash,
                           self.ak, self.sk, amz_date, self.region)
        scope = f"{amz_date[:8]}/{self.region}/s3/aws4_request"
        headers["authorization"] = (
            f"{auth.SIGN_V4_ALGORITHM} Credential={self.ak}/{scope}, "
            f"SignedHeaders={';'.join(signed)}, Signature={sig}")
        return sig

    def _send(self, method, path, query, headers, body):
        import urllib.parse

        qs = urllib.parse.urlencode(query or {})
        url = urllib.parse.quote(path) + (f"?{qs}" if qs else "")
        self.conn.request(method, url, body=body or None, headers=headers)
        r = self.conn.getresponse()
        data = r.read()
        return r.status, {k.lower(): v for k, v in r.getheaders()}, data

    def request(self, method, path, query=None, body=b"", headers=None,
                unsigned_payload=False, anonymous=False, payload_hash=None):
        """(status, headers, body); the payload is signed by its sha256
        (``payload_hash`` when the caller computed it) unless
        ``unsigned_payload`` (x-amz-content-sha256: UNSIGNED-PAYLOAD)."""
        import hashlib

        from minio_tpu_torch.server import auth

        headers = {k.lower(): v for k, v in (headers or {}).items()}
        headers["host"] = f"{self.host}:{self.port}"
        if not anonymous:
            phash = (auth.UNSIGNED_PAYLOAD if unsigned_payload
                     else payload_hash or hashlib.sha256(body).hexdigest())
            headers["x-amz-date"] = self._now()
            headers["x-amz-content-sha256"] = phash
            self._sign(method, path, query, headers, phash)
        return self._send(method, path, query, headers, body)

    def put_chunked(self, path, data: bytes, chunk: int = 1 << 20):
        """PUT with STREAMING-AWS4-HMAC-SHA256-PAYLOAD framing: every
        chunk signed, chained from the seed signature."""
        import hashlib
        import hmac

        from minio_tpu_torch.server import auth

        headers = {
            "host": f"{self.host}:{self.port}",
            "x-amz-date": self._now(),
            "x-amz-content-sha256": auth.STREAMING_PAYLOAD,
            "x-amz-decoded-content-length": str(len(data)),
            "content-encoding": "aws-chunked",
        }
        prev = self._sign("PUT", path, None, headers, auth.STREAMING_PAYLOAD)
        amz_date = headers["x-amz-date"]
        key = auth._signing_key(self.sk, amz_date[:8], self.region, "s3")
        scope = f"{amz_date[:8]}/{self.region}/s3/aws4_request"
        body = bytearray()
        pieces = [data[i:i + chunk] for i in range(0, len(data), chunk)]
        for c in [*pieces, b""]:
            sts = "\n".join(["AWS4-HMAC-SHA256-PAYLOAD", amz_date, scope,
                             prev, auth.EMPTY_SHA256,
                             hashlib.sha256(c).hexdigest()])
            prev = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
            body += f"{len(c):x};chunk-signature={prev}\r\n".encode()
            if c:
                body += c + b"\r\n"
        body += b"\r\n"
        return self._send("PUT", path, None, headers, bytes(body))

    def close(self) -> None:
        self.conn.close()


MESH_SHAPES = ((K, M, 4, 1), (K, M, 2, 2), (K, M, 1, 4),
               # EC 12+4 on 6 slots: a shard axis of 3, the all-reduce's fold
               (12, 4, 2, 3))
MESH_B = 4
MESH_ABSENT = (0, 2, 5, 7)  # the 4 data shards mesh_reconstruct rebuilds
MESH_POLICIES = ("span", "route", "auto")
MESH_OBJECTS = (64 << 20, BLOCK + 17)
MESH_SLOTS = 4  # the object layer's mesh: the card 4 times
MESH_KERNELS = ("encode_pack", "phash256_batched", "gf_matmul_words",
                "verify_reconstruct")


def launches_since(before: dict) -> dict:
    """kernels.LAUNCHES moved since ``before`` (the names that moved)."""
    from minio_tpu_torch.ops import kernels

    return {name: n - before.get(name, 0)
            for name, n in kernels.LAUNCHES.items() if n != before.get(name, 0)}


def mesh_shard_words(k: int) -> int:
    """Words a shard of a BLOCK split k ways (bytes rounded up to 32)."""
    nbytes = -(-BLOCK // k)
    return -(-nbytes // 32) * 8


def mesh_entries(dev, k: int, m: int, stripe: int, shard: int, rng) -> dict:
    """Part (a) on one mesh: every mesh entry point over ``stripe x
    shard`` slots that repeat ``dev``, bit for bit against the
    single-device kernels (K1, K2, K3, K4) on the same inputs, each
    checked on a first call and timed on a second; the launches of the
    mesh calls alone."""
    import numpy as np
    import torch

    from minio_tpu_torch.ops import codec_step, kernels
    from minio_tpu_torch.parallel import mesh as pm

    n, w, B = k + m, mesh_shard_words(k), MESH_B
    L = 4 * w
    words = rng.integers(0, 1 << 32, (B, k, w), dtype=np.uint64).astype(np.uint32)
    data_b = words.view(np.uint8)

    def host(t):
        return codec_step.tensor_to_words(t)

    # the single-device kernels' answers, before the mesh's launches count
    words_d = torch.from_numpy(words.view(np.int32)).to(dev)
    par_d, dig_d, _f, _p = codec_step.encode_words_fused1(words_d, m, L)
    parity, digests = host(par_d), host(dig_d)
    shards = np.concatenate([words, parity], axis=1)
    shards_d = torch.from_numpy(shards.view(np.int32)).to(dev)
    present = tuple(i not in MESH_ABSENT for i in range(n))
    recon = host(codec_step.reconstruct_words_batch(shards_d, present, k, m))
    bad = shards.copy()
    bad[1, 3, 17] ^= 1 << 16  # bitrot in a survivor of stripe 1
    vr_d, ok_d = codec_step.verify_and_reconstruct_words(
        torch.from_numpy(bad.view(np.int32)).to(dev), dig_d, (True,) * n, k, m,
        L)
    vr_data, vr_ok = host(vr_d), ok_d.cpu().numpy()
    rows = shards.reshape(B * n, w)
    row_digests = host(kernels.phash256_batched(
        torch.from_numpy(rows.view(np.int32)).to(dev), L))
    slots = stripe * shard
    seq_w = w - w % slots
    seq_src = np.ascontiguousarray(data_b[0][:, :4 * seq_w])
    torch.cuda.synchronize()
    if not np.array_equal(recon, words):
        fail(f"mesh {stripe}x{shard}: the single-device reconstruct is wrong")
    if vr_ok[1, 3] or not np.array_equal(row_digests.reshape(B, n, 8), digests):
        fail(f"mesh {stripe}x{shard}: the single-device verify is wrong")

    mesh = pm.make_mesh((dev,) * slots, stripe, shard)
    cases = {
        "sharded_encode": (
            lambda: np.asarray(pm.sharded_encode(mesh, data_b, m)),
            (parity.view(np.uint8),)),
        "sharded_encode_seq": (
            lambda: np.asarray(pm.sharded_encode_seq(mesh, seq_src, m)),
            (np.ascontiguousarray(parity[0][:, :seq_w]).view(np.uint8),)),
        "mesh_encode_hash": (
            lambda: pm.mesh_encode_hash(mesh, words, m, L), (parity, digests)),
        "mesh_reconstruct": (
            lambda: pm.mesh_reconstruct(mesh, shards, present, k, m), (recon,)),
        "mesh_verify_reconstruct": (
            lambda: pm.mesh_verify_reconstruct(mesh, bad, digests, (True,) * n,
                                               k, m, L),
            (vr_data, vr_ok)),
        "mesh_digest": (
            lambda: pm.mesh_digest(mesh, rows, L), (row_digests,)),
    }
    out = {"k": k, "m": m, "stripe": stripe, "shard": shard, "B": B,
           "words_per_shard": w, "wall_ms": {}}
    before = dict(kernels.LAUNCHES)
    for name, (call, want) in cases.items():
        for turn in ("check", "timed"):
            t0 = time.monotonic()
            got = call()
            ms = (time.monotonic() - t0) * 1e3
            got = got if isinstance(got, tuple) else (got,)
            if len(got) != len(want) or not all(
                    np.array_equal(a, b) for a, b in zip(got, want)):
                fail(f"mesh {stripe}x{shard} (EC {k}+{m}): {name} differs from"
                     " the single-device kernels")
        out["wall_ms"][name] = ms
    if vr_ok[1, 3]:
        fail("mesh_verify_reconstruct: the bitrotted survivor verified ok")
    # begin queues the pass and returns; end is the sync point
    t0 = time.monotonic()
    handle = pm.mesh_encode_hash_begin(mesh, words, m, L)
    t1 = time.monotonic()
    got = pm.mesh_encode_hash_end(handle)
    t2 = time.monotonic()
    if not (np.array_equal(got[0], parity) and np.array_equal(got[1], digests)):
        fail(f"mesh {stripe}x{shard}: mesh_encode_hash begin/end differs")
    out["wall_ms"]["mesh_encode_hash_begin"] = (t1 - t0) * 1e3
    out["wall_ms"]["mesh_encode_hash_end"] = (t2 - t1) * 1e3
    out["launches"] = launches_since(before)
    return out


def mesh_objects(dev, work: str, rng) -> dict:
    """Part (b): one erasure set (12 disks, EC 8+4, 10 MiB blocks) whose
    codec is BatchingBackend(instrument(TorchBackend(devices=(dev,) *
    4))), under each placement policy with one-slot submeshes: PUT,
    healthy GET, GET with 4 drives offline, heal; every body equals its
    source, every part file and xl.meta a single-slot backend's."""
    from minio_tpu_torch.codec.backend import TorchBackend
    from minio_tpu_torch.codec.batcher import BatchingBackend
    from minio_tpu_torch.codec.telemetry import KERNEL_STATS, instrument
    from minio_tpu_torch.objectlayer.erasure_object import (
        ErasureObjects,
        from_reference_disks,
    )
    from minio_tpu_torch.ops import kernels
    from minio_tpu_torch.storage.xl import XLStorage

    payloads = [rng.bytes(s) for s in MESH_OBJECTS]
    names = [f"mesh{i}" for i in range(len(payloads))]
    total = sum(MESH_OBJECTS)

    def layer(roots, backend, alive=None):
        paths = [r if alive is None or d in alive else None
                 for d, r in enumerate(roots)]
        ol = from_reference_disks(paths, parity_blocks=M, block_size=BLOCK,
                                  device=dev)
        ol.backend = backend
        return ol

    single = BatchingBackend(instrument(TorchBackend(dev)))
    ref_roots = [os.path.join(work, f"mesh-ref{i}") for i in range(N)]
    try:
        ol = layer(ref_roots, single)
        ol.make_bucket("bench")
        for name, data in zip(names, payloads):
            ol.put_object("bench", name, io.BytesIO(data), len(data))
    finally:
        single.shutdown()
    written = {name: object_files(ref_roots, name) for name in names}
    runs = {}
    try:
        for policy in MESH_POLICIES:
            os.environ["MINIO_TPU_PLACEMENT"] = policy
            os.environ["MINIO_TPU_SUBMESH_DEVICES"] = "1"
            be = BatchingBackend(instrument(TorchBackend(devices=(dev,) * MESH_SLOTS)))
            roots = [os.path.join(work, f"mesh-{policy}{i}") for i in range(N)]
            secs = {"put": 0.0, "get": 0.0, "get_degraded": 0.0, "heal": 0.0}
            try:
                ol = layer(roots, be)
                ol.make_bucket("bench")
                KERNEL_STATS.reset()
                before = dict(kernels.LAUNCHES)
                for name, data in zip(names, payloads):
                    t0 = time.monotonic()
                    ol.put_object("bench", name, io.BytesIO(data), len(data))
                    secs["put"] += time.monotonic() - t0
                for name, data in zip(names, payloads):
                    sink = io.BytesIO()
                    t0 = time.monotonic()
                    ol.get_object("bench", name, sink)
                    secs["get"] += time.monotonic() - t0
                    if sink.getvalue() != data:
                        fail(f"mesh {policy}: GET of {name} differs from its source")
                for name, data in zip(names, payloads):
                    dist = XLStorage(roots[0]).read_version("bench", name).erasure.distribution
                    dead = {d for d in range(N) if dist[d] in (1, 3, 10, 12)}
                    sink = io.BytesIO()
                    t0 = time.monotonic()
                    layer(roots, be, set(range(N)) - dead).get_object("bench", name, sink)
                    secs["get_degraded"] += time.monotonic() - t0
                    if sink.getvalue() != data:
                        fail(f"mesh {policy}: degraded GET of {name} differs")
                    for d in dead:
                        shutil.rmtree(os.path.join(roots[d], "bench", name))
                    t0 = time.monotonic()
                    healed = ol.heal_object("bench", name)["healed"]
                    secs["heal"] += time.monotonic() - t0
                    if sorted(healed) != [0, 2, 9, 11]:
                        fail(f"mesh {policy}: heal of {name} rebuilt {healed}")
                for name in names:
                    if object_files(roots, name) != written[name]:
                        fail(f"mesh {policy}: {name}'s part files or xl.meta differ"
                             " from the single-slot backend's")
                launches = launches_since(before)
                stats = KERNEL_STATS.snapshot()
            finally:
                be.shutdown()
            runs[policy] = {
                **{f"{op}_MBps": total / s / 1e6 for op, s in secs.items()},
                "seconds": secs,
                "placement": stats["placement"],
                "submesh_depth_peaks": {s["submesh"]: s["depth_hwm"]
                                        for s in stats["submeshes"]},
                "device_passes": stats["device_passes"],
                "launches": launches,
            }
    finally:
        os.environ.pop("MINIO_TPU_PLACEMENT", None)
        os.environ.pop("MINIO_TPU_SUBMESH_DEVICES", None)
    if runs["span"]["placement"]["route"] or not runs["route"]["placement"]["route"]:
        fail(f"mesh: placement counters off: {runs}")
    if "mesh_encode_hash" not in runs["span"]["device_passes"]:
        fail("mesh span: the PUT took no mesh pass")
    return {"objects": len(names), "bytes": total, "policies": runs}


def mesh_phase(dev, work: str) -> dict:
    """Phase 6b: the device mesh on the card (parts (a) and (b) above);
    fails unless K1-K4 launched in the mesh runs."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + 10)
    t0 = time.monotonic()
    shapes = {
        f"EC {k}+{m} {s}x{h}": mesh_entries(dev, k, m, s, h, rng)
        for k, m, s, h in MESH_SHAPES
    }
    torch.cuda.empty_cache()
    objects = mesh_objects(dev, work, rng)
    launches: dict = {}
    for run in list(shapes.values()) + list(objects["policies"].values()):
        for name, c in run["launches"].items():
            launches[name] = launches.get(name, 0) + c
    for name in MESH_KERNELS:
        if launches.get(name, 0) <= 0:
            fail(f"kernel {name} never launched in the mesh phase")
    return {"card": card_name(), "seconds": time.monotonic() - t0,
            "shapes": shapes, **objects, "launches": launches}


def _in_clients(host, port, jobs_per_client, fn,
                cafile: "str | None" = None) -> "tuple[float, list]":
    """Run ``fn(signer, job)`` for each client's jobs, S3_CLIENTS clients
    at once on their own connections (TLS against ``cafile`` when it is
    given); (wall seconds, results)."""
    import threading

    results: list = [None] * len(jobs_per_client)
    errors: list = []
    start = threading.Barrier(len(jobs_per_client) + 1)

    def run(ix):
        signer = S3Signer(host, port, cafile=cafile)
        try:
            start.wait()
            results[ix] = [fn(signer, job) for job in jobs_per_client[ix]]
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)
        finally:
            signer.close()

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(jobs_per_client))]
    for t in threads:
        t.start()
    start.wait()
    t0 = time.monotonic()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    if errors:
        fail(f"S3 phase: a client failed: {errors[0]!r}")
    return wall, [r for rs in results for r in rs]


def s3_phase(dev, work: str, payloads: list, written: dict, mp: dict) -> dict:
    """Phase 7: the main path through the S3 front.  The port's S3Server
    (threaded plane) over a fresh ErasureObjects on the card (12 disks,
    EC 8+4, 10 MiB blocks), driven by 4 concurrent SigV4 clients."""
    import hashlib
    import xml.etree.ElementTree as ET

    import numpy as np

    from minio_tpu_torch.codec.telemetry import KERNEL_STATS
    from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
    from minio_tpu_torch.ops import kernels
    from minio_tpu_torch.server.http import S3Server
    from minio_tpu_torch.storage.xl import XLStorage

    roots = [os.path.join(work, f"s3disk{i}") for i in range(N)]
    ol = ErasureObjects([XLStorage(r) for r in roots], parity_blocks=M,
                        block_size=BLOCK)
    srv = S3Server(ol, address="127.0.0.1:0").start()
    if srv.server_mode != "threaded":
        fail(f"S3 phase: server plane {srv.server_mode}")
    host, port = srv.host, srv.port
    rng = np.random.default_rng(SEED + 7)
    big = {f"c{c}/big{j}": rng.bytes(S3_BIG)
           for c in range(S3_CLIENTS) for j in range(2)}
    small = {"public/small": rng.bytes(1024)}
    objects = {**small, "obj4": payloads[4], **big}
    sha = {k: hashlib.sha256(v).digest() for k, v in objects.items()}

    # bucket documents: every read that finds one is an erasure GET on
    # the card; count them (this script's own instrumentation)
    bms = srv.bucket_meta
    doc = {"loads": 0, "found": 0}
    load = bms._load

    def counted_load(bucket):
        bm = load(bucket)
        doc["loads"] += 1
        doc["found"] += bool(bm.created_ns)
        return bm

    bms._load = counted_load
    one = S3Signer(host, port)
    out: dict = {}
    try:
        kernels.reset_launches()
        KERNEL_STATS.reset()
        t_phase = time.monotonic()
        st, _h, body = one.request("PUT", "/bench")
        if st != 200:
            fail(f"S3 phase: bucket create {st} {body[:200]!r}")
        before = dict(kernels.LAUNCHES)
        st, _h, body = one.request("PUT", "/bench", {"policy": ""}, S3_POLICY)
        if st != 204:
            fail(f"S3 phase: bucket policy {st} {body[:200]!r}")
        doc_write = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
                     if v != before[k]}
        # one bucket-document read on a quiet card: its launches
        bms.invalidate("bench")
        before = dict(kernels.LAUNCHES)
        if bms.get("bench").policy() is None:
            fail("S3 phase: the bucket policy did not read back")
        doc_read = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
                    if v != before[k]}
        doc["loads"] = doc["found"] = 0

        st, _h, body = one.request("PUT", "/bench/public/small",
                                   body=small["public/small"])
        if st != 200:
            fail(f"S3 phase: PUT public/small {st} {body[:200]!r}")
        # the 10 MiB + 17 B object alone: PUT signed by its sha256 (the
        # server verifies it) and again UNSIGNED-PAYLOAD, each read back
        single = {"put_signed_s": [], "put_unsigned_s": [], "get_s": []}
        for unsigned in (False, True):
            t0 = time.monotonic()
            st, _h, body = one.request(
                "PUT", "/bench/obj4", body=objects["obj4"],
                unsigned_payload=unsigned, payload_hash=sha["obj4"].hex())
            single["put_unsigned_s" if unsigned else "put_signed_s"].append(
                time.monotonic() - t0)
            if st != 200:
                fail(f"S3 phase: PUT obj4 {st} {body[:200]!r}")
            t0 = time.monotonic()
            st, _h, got = one.request("GET", "/bench/obj4")
            single["get_s"].append(time.monotonic() - t0)
            if st != 200 or hashlib.sha256(got).digest() != sha["obj4"]:
                fail("S3 phase: single-client GET of obj4 differs from its source")
        st, _h, got = one.request("GET", "/bench/public/small", anonymous=True)
        if st != 200 or got != small["public/small"]:
            fail(f"S3 phase: anonymous GET under the bucket policy: {st}")
        for d, r in enumerate(roots):
            part = part_files(r, "bench", "obj4")
            want = written["obj4"][d]
            if part is None or want is None or part != want[0]:
                fail(f"S3 phase: obj4 part file on disk {d} differs from the main path's")

        # concurrent PUT: each client two 64 MiB objects; client 0's
        # second one aws-chunked, the others UNSIGNED-PAYLOAD
        def put(signer, key):
            if key == "c0/big1":
                st, _h, body = signer.put_chunked(f"/bench/{key}", big[key])
            else:
                st, _h, body = signer.request(
                    "PUT", f"/bench/{key}", body=big[key],
                    unsigned_payload=True)
            if st != 200:
                fail(f"S3 phase: PUT {key}: {st} {body[:200]!r}")
            return key

        jobs = [[f"c{c}/big{j}" for j in range(2)] for c in range(S3_CLIENTS)]
        b0 = KERNEL_STATS.snapshot()["batch"]
        put_wall, _ = _in_clients(host, port, jobs, put)
        b1 = KERNEL_STATS.snapshot()["batch"]

        def get(signer, key):
            st, _h, body = signer.request("GET", f"/bench/{key}")
            if st != 200 or hashlib.sha256(body).digest() != sha[key]:
                fail(f"S3 phase: GET {key}: {st}, body differs from its source")
            return len(body)

        all_keys = sorted(objects)
        get_jobs = [all_keys[c::S3_CLIENTS] for c in range(S3_CLIENTS)]
        get_wall, sizes = _in_clients(host, port, get_jobs, get)
        b2 = KERNEL_STATS.snapshot()["batch"]
        lo = BLOCK - 60
        st, h, got = one.request("GET", "/bench/c1/big0",
                                 headers={"range": f"bytes={lo}-{lo + 200}"})
        if st != 206 or got != big["c1/big0"][lo:lo + 201]:
            fail(f"S3 phase: ranged GET across a block boundary: {st}")
        for key in all_keys:
            st, h, _b = one.request("HEAD", f"/bench/{key}")
            if (st != 200 or int(h["content-length"]) != len(objects[key])
                    or h["etag"] != f'"{hashlib.md5(objects[key]).hexdigest()}"'):
                fail(f"S3 phase: HEAD {key}: {st} {h}")
        listed, token, pages = [], "", 0
        while True:
            q = {"list-type": "2", "max-keys": "3"}
            if token:
                q["continuation-token"] = token
            st, _h, body = one.request("GET", "/bench", q)
            if st != 200:
                fail(f"S3 phase: ListObjectsV2 {st}")
            root = ET.fromstring(body)
            ns = root.tag[: root.tag.index("}") + 1]
            listed += [e.text for e in root.iter(f"{ns}Key")]
            pages += 1
            if root.findtext(f"{ns}IsTruncated") != "true":
                break
            token = root.findtext(f"{ns}NextContinuationToken")
        if listed != all_keys:
            fail(f"S3 phase: ListObjectsV2 paged {listed} != {all_keys}")

        # degraded: the disks of obj4's shards 1, 3, 10 and 12 offline
        dist = XLStorage(roots[0]).read_version("bench", "obj4").erasure.distribution
        dead = sorted(d for d in range(N) if dist[d] in (1, 3, 10, 12))
        live = list(ol.disks)
        for d in dead:
            ol.disks[d] = None
        try:
            k3 = kernels.LAUNCHES["gf_matmul_words"]
            deg_wall, _ = _in_clients(host, port, get_jobs, get)
            if kernels.LAUNCHES["gf_matmul_words"] <= k3:
                fail("S3 phase: the degraded GETs reconstructed nothing")
        finally:
            ol.disks[:] = live
        b3 = KERNEL_STATS.snapshot()["batch"]

        for key in all_keys:
            st, _h, body = one.request("DELETE", f"/bench/{key}")
            if st != 204:
                fail(f"S3 phase: DELETE {key}: {st} {body[:200]!r}")
        st, _h, _b = one.request("GET", "/bench/obj4")
        if st != 404:
            fail(f"S3 phase: GET after DELETE answered {st}")
        st, _h, body = one.request("DELETE", "/bench")
        if st != 204:
            fail(f"S3 phase: bucket delete {st} {body[:200]!r}")
        phase_s = time.monotonic() - t_phase
        launches = dict(kernels.LAUNCHES)
        stats = KERNEL_STATS.snapshot()
    finally:
        one.close()
        bms._load = load
        srv.shutdown()
        for r in roots:
            shutil.rmtree(r, ignore_errors=True)

    for name in ("encode_pack_pipelined", "phash256_batched", "gf_matmul_words"):
        if launches[name] <= 0:
            fail(f"S3 phase: kernel {name} never launched")
    for name in ("encode_pack", "encode_pack[mxu]", "encode_pack_pipelined[mxu]"):
        if launches[name]:
            fail(f"S3 phase: kernel {name} launched")

    def merged(a, b):
        return {k: b[k] - a[k] for k in ("flushes", "jobs", "multi_client_flushes",
                                         "wait_seconds")}

    put_batch, get_batch, deg_batch = merged(b0, b1), merged(b1, b2), merged(b2, b3)
    cross = sum(x["multi_client_flushes"] for x in (put_batch, get_batch, deg_batch))
    if cross <= 0:
        fail("S3 phase: no batcher flush merged jobs of more than one client")
    nbig = sum(len(v) for v in big.values())
    nall = sum(sizes)
    obj4 = len(payloads[4])
    out = {
        "clients": S3_CLIENTS,
        "objects": len(objects),
        "server_mode": "threaded",
        "phase_s": phase_s,
        "put_concurrent": {"bytes": nbig, "s": put_wall,
                           "MBps": nbig / put_wall / 1e6},
        "get_concurrent": {"bytes": nall, "s": get_wall,
                           "MBps": nall / get_wall / 1e6},
        "get_degraded_concurrent": {"bytes": nall, "s": deg_wall,
                                    "MBps": nall / deg_wall / 1e6,
                                    "offline_disks": dead},
        "obj4_single_client": {
            "bytes": obj4, **single,
            **{k[:-2] + "_MBps": [obj4 / t / 1e6 for t in v]
               for k, v in single.items()},
            "main_path_put_s": mp["put_each_s"][4],
            "main_path_get_s": mp["get_each_s"][4],
            "main_path_put_MBps": obj4 / mp["put_each_s"][4] / 1e6,
            "main_path_get_MBps": obj4 / mp["get_each_s"][4] / 1e6,
        },
        "list_pages": pages,
        "launches": {k: v for k, v in launches.items() if v},
        "batch": {"put": put_batch, "get": get_batch, "get_degraded": deg_batch,
                  "jobs_per_flush": {
                      name: (x["jobs"] / x["flushes"] if x["flushes"] else None)
                      for name, x in (("put", put_batch), ("get", get_batch),
                                      ("get_degraded", deg_batch))}},
        "bucket_doc": {
            "write_launches": doc_write,
            "read_launches_each": doc_read,
            "reads_in_phase": doc["found"],
            "loads_in_phase": doc["loads"],
            "read_launches_in_phase": {
                k: v * doc["found"] for k, v in doc_read.items()},
        },
        "stages": stats["stages"],
    }
    return out


# -- phase 8: multipart, copies, versions, multi-delete, POST policy ----------

MP_PART = 8 << 20  # the AWS CLI's multipart chunk
MP_MIN_PART = 5 << 20  # S3's minimum part (the object layer's default)
MP_SHARDS_OFF = (1, 3, 10, 12)


def _mp_etag(parts: list) -> str:
    import hashlib

    md5s = b"".join(hashlib.md5(p).digest() for p in parts)
    return f"{hashlib.md5(md5s).hexdigest()}-{len(parts)}"


def _xml_text(body: bytes, tag: str) -> list:
    import xml.etree.ElementTree as ET

    root = ET.fromstring(body)
    ns = root.tag[: root.tag.index("}") + 1] if root.tag.startswith("{") else ""
    return [e.text or "" for e in root.iter(f"{ns}{tag}")]


def _complete_body(etags: list) -> bytes:
    return ("<CompleteMultipartUpload>" + "".join(
        f'<Part><PartNumber>{n}</PartNumber><ETag>"{e}"</ETag></Part>'
        for n, e in enumerate(etags, 1)) + "</CompleteMultipartUpload>").encode()


def _post_policy_form(signer, bucket: str, key: str, data: bytes):
    """(body, content type) of a browser form upload whose policy is
    signed with the signer's key (SigV4 POST policy)."""
    import base64
    import datetime
    import hashlib
    import hmac

    from minio_tpu_torch.server import auth

    amz_date = signer._now()
    scope = f"{amz_date[:8]}/{signer.region}/s3/aws4_request"
    credential = f"{signer.ak}/{scope}"
    exp = (datetime.datetime.now(datetime.timezone.utc)
           + datetime.timedelta(seconds=600)).strftime("%Y-%m-%dT%H:%M:%S.000Z")
    policy = base64.b64encode(json.dumps({"expiration": exp, "conditions": [
        {"bucket": bucket}, ["eq", "$key", key],
        {"x-amz-credential": credential}, {"x-amz-date": amz_date},
        {"x-amz-algorithm": auth.SIGN_V4_ALGORITHM},
    ]}).encode()).decode()
    skey = auth._signing_key(signer.sk, amz_date[:8], signer.region, "s3")
    fields = {
        "key": key, "policy": policy,
        "x-amz-algorithm": auth.SIGN_V4_ALGORITHM,
        "x-amz-credential": credential, "x-amz-date": amz_date,
        "x-amz-signature": hmac.new(skey, policy.encode(),
                                    hashlib.sha256).hexdigest(),
    }
    boundary = "----chipsmoke"
    body = bytearray()
    for k, v in fields.items():
        body += (f"--{boundary}\r\nContent-Disposition: form-data; "
                 f'name="{k}"\r\n\r\n{v}\r\n').encode()
    body += (f"--{boundary}\r\nContent-Disposition: form-data; "
             f'name="file"; filename="f.bin"\r\n'
             f"Content-Type: application/octet-stream\r\n\r\n").encode()
    body += data + f"\r\n--{boundary}--\r\n".encode()
    return bytes(body), f"multipart/form-data; boundary={boundary}"


def _staged_hashes(roots: list, upload_id: str, nparts: int) -> list:
    """Per disk: the sha256 of each staged ``part.N`` (None if absent)."""
    import hashlib

    out = []
    for r in roots:
        row = []
        for n in range(1, nparts + 1):
            p = os.path.join(r, ".sys", "multipart", upload_id, f"part.{n}")
            try:
                with open(p, "rb") as f:
                    row.append(hashlib.sha256(f.read()).hexdigest())
            except OSError:
                row.append(None)
        out.append(row)
    return out


def _object_hashes(roots: list, bucket: str, key: str) -> list:
    """Per disk: the sha256 of each of the object's ``part.N`` files
    (None where the disk lacks the object)."""
    import hashlib

    from minio_tpu_torch.storage import errors as serrors
    from minio_tpu_torch.storage.xl import XLStorage

    out = []
    for r in roots:
        try:
            fi = XLStorage(r).read_version(bucket, key)
        except serrors.FileNotFound:
            out.append(None)
            continue
        row = []
        for part in fi.parts:
            with open(os.path.join(r, bucket, key, fi.data_dir,
                                   f"part.{part.number}"), "rb") as f:
                row.append(hashlib.sha256(f.read()).hexdigest())
        out.append(row)
    return out


def _by_index(roots: list, bucket: str, key: str, part: int) -> dict:
    """Erasure index -> bytes of the object's ``part.<part>`` on that
    index's disk."""
    from minio_tpu_torch.storage.xl import XLStorage

    out = {}
    for r in roots:
        fi = XLStorage(r).read_version(bucket, key)
        with open(os.path.join(r, bucket, key, fi.data_dir, f"part.{part}"),
                  "rb") as f:
            out[fi.erasure.index] = f.read()
    return out


def s3_mp_phase(dev, work: str, payloads: list) -> dict:
    """Phase 8: multipart uploads, uploads in progress, multipart reads
    (healthy, degraded, ranged across a part boundary), UploadPartCopy,
    CopyObject and the self-copy, heal of a multipart object, then
    ListObjectVersions, a POST-policy upload and a quiet multi-delete -
    through the port's S3Server (threaded plane) over a fresh
    ErasureObjects on the card (12 disks, EC 8+4, 10 MiB blocks), by 4
    SigV4 clients on keep-alive connections."""
    import hashlib
    import xml.etree.ElementTree as ET

    import numpy as np

    from minio_tpu_torch.codec.telemetry import KERNEL_STATS
    from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
    from minio_tpu_torch.ops import kernels
    from minio_tpu_torch.server.http import S3Server
    from minio_tpu_torch.storage.xl import XLStorage

    roots = [os.path.join(work, f"s3mpdisk{i}") for i in range(N)]
    ol = ErasureObjects([XLStorage(r) for r in roots], parity_blocks=M,
                        block_size=BLOCK)
    if getattr(ol, "min_part_size", MP_MIN_PART) != MP_MIN_PART:
        fail("S3 mp phase: the object layer's minimum part is not 5 MiB")
    srv = S3Server(ol, address="127.0.0.1:0").start()
    host, port = srv.host, srv.port
    rng = np.random.default_rng(SEED + 8)
    objs = {f"mp{c}": rng.bytes(S3_BIG) for c in range(S3_CLIENTS)}
    objs["mp-small"] = payloads[4]  # the 10 MiB + 17 B object
    splits = {k: [v[i:i + MP_PART] for i in range(0, len(v), MP_PART)]
              for k, v in objs.items() if k != "mp-small"}
    small = objs["mp-small"]
    splits["mp-small"] = [small[:MP_MIN_PART],
                          small[MP_MIN_PART:2 * MP_MIN_PART],
                          small[2 * MP_MIN_PART:]]
    if [len(p) for p in splits["mp-small"]] != [MP_MIN_PART, MP_MIN_PART, 17]:
        fail("S3 mp phase: the 10 MiB + 17 B object did not split 5/5/17")
    one = S3Signer(host, port)
    out: dict = {}

    def req(method, path, query=None, body=b"", headers=None, want=200,
            what="", **kw):
        st, h, b = one.request(method, path, query, body, headers, **kw)
        if st != want:
            fail(f"S3 mp phase: {what or method + ' ' + path}: {st} {b[:300]!r}")
        return h, b

    def launched() -> dict:
        return dict(kernels.LAUNCHES)

    def delta(a: dict, b: dict) -> dict:
        return {k: b[k] - a.get(k, 0) for k in b if b[k] != a.get(k, 0)}

    try:
        kernels.reset_launches()
        KERNEL_STATS.reset()
        t_phase = time.monotonic()
        req("PUT", "/mpb", what="bucket create")

        # -- 1. multipart upload: 4 clients, 8 x 8 MiB parts each, at once
        uploads: dict = {}

        def upload_parts(signer, key):
            st, _h, b = signer.request("POST", f"/mpb/{key}", {"uploads": ""})
            if st != 200:
                fail(f"S3 mp phase: initiate {key}: {st} {b[:200]!r}")
            uid = _xml_text(b, "UploadId")[0]
            etags = []
            for n, part in enumerate(splits[key], 1):
                st, h, b = signer.request(
                    "PUT", f"/mpb/{key}",
                    {"partNumber": str(n), "uploadId": uid}, part,
                    unsigned_payload=True)
                if st != 200:
                    fail(f"S3 mp phase: part {n} of {key}: {st} {b[:200]!r}")
                etags.append(h["etag"].strip('"'))
            uploads[key] = (uid, etags)
            return key

        l0, b0 = launched(), KERNEL_STATS.snapshot()["batch"]
        put_wall, _ = _in_clients(
            host, port, [[f"mp{c}"] for c in range(S3_CLIENTS)], upload_parts)
        l1, b1 = launched(), KERNEL_STATS.snapshot()["batch"]
        nparts = sum(len(splits[f"mp{c}"]) for c in range(S3_CLIENTS))
        put_launch = delta(l0, l1)
        put_batch = {k: b1[k] - b0[k]
                     for k in ("flushes", "jobs", "multi_client_flushes")}
        # each part is one encode job; a flush that merges jobs of
        # several clients encodes them in one K5 launch
        merged = put_batch["jobs"] - put_batch["flushes"]
        k5 = put_launch.get("encode_pack_pipelined", 0)
        if k5 <= 0 or k5 + merged < nparts:
            fail(f"S3 mp phase: {k5} K5 launches (+{merged} merged jobs) for "
                 f"{nparts} parts")
        for name in ("encode_pack", "encode_pack[mxu]"):
            if put_launch.get(name):
                fail(f"S3 mp phase: kernel {name} launched on the part PUTs")
        # the small object alone: one K5 launch per part
        lsm = launched()
        upload_parts(one, "mp-small")
        small_launch = delta(lsm, launched())
        if small_launch.get("encode_pack_pipelined", 0) < 3:
            fail(f"S3 mp phase: the 3-part upload launched {small_launch}")

        # a disk whose staged part is missing - a write that lost a race
        # with another request's pruning of .sys/tmp (XLStorage, in both
        # packages) - must lack the completed object; the others must
        # hold exactly the staged files
        complete_s, staged, short = {}, {}, {}
        for key in sorted(uploads):
            uid, etags = uploads[key]
            _h, b = req("GET", f"/mpb/{key}", {"uploadId": uid},
                        what=f"ListParts {key}")
            want = [hashlib.md5(p).hexdigest() for p in splits[key]]
            if [e.strip('"') for e in _xml_text(b, "ETag")] != want or etags != want:
                fail(f"S3 mp phase: ListParts of {key} disagrees with the parts")
            staged[key] = _staged_hashes(roots, uid, len(etags))
            lc = launched()
            t0 = time.monotonic()
            _h, b = req("POST", f"/mpb/{key}", {"uploadId": uid},
                        _complete_body(etags), what=f"Complete {key}")
            complete_s[key] = time.monotonic() - t0
            if delta(lc, launched()):
                fail(f"S3 mp phase: CompleteMultipartUpload of {key} launched "
                     f"{delta(lc, launched())}")
            etag = _xml_text(b, "ETag")[0].strip('"')
            if etag != _mp_etag(splits[key]):
                fail(f"S3 mp phase: ETag of {key} {etag} != {_mp_etag(splits[key])}")
            for d, (got, want) in enumerate(zip(
                    _object_hashes(roots, "mpb", key), staged[key])):
                if None in want:
                    short.setdefault(key, []).append(d)
                    if got is not None:
                        fail(f"S3 mp phase: {key} completed on disk {d}, "
                             "which lacks staged parts")
                elif got != want:
                    fail(f"S3 mp phase: {key}'s shard files on disk {d} are "
                         "not the staged ones")
        # the set's own repair for a write that missed disks: heal them
        # before anything reads with disks offline
        lr = launched()
        for key, disks in short.items():
            # the distribution from a disk that holds the completed object
            src = next(d for d in range(N) if d not in disks)
            dist_k = XLStorage(roots[src]).read_version("mpb", key).erasure.distribution
            res = ol.heal_object("mpb", key)
            if sorted(res["healed"]) != sorted(dist_k[d] - 1 for d in disks):
                fail(f"S3 mp phase: repair of {key} healed {res['healed']}")
        repair_launch = delta(lr, launched())
        # one 8 MiB part against a single put_object of the same bytes
        ol.put_object("mpb", "single8", io.BytesIO(splits["mp0"][0]), MP_PART)
        if _by_index(roots, "mpb", "mp0", 1) != _by_index(roots, "mpb",
                                                          "single8", 1):
            fail("S3 mp phase: part 1 of mp0 differs from a single PUT of it")
        ol.delete_object("mpb", "single8")

        # -- 2. uploads in progress
        _h, b = req("POST", "/mpb/pending", {"uploads": ""})
        pending = _xml_text(b, "UploadId")[0]
        req("PUT", "/mpb/pending", {"partNumber": "1", "uploadId": pending},
            b"p" * 1024)
        _h, b = req("GET", "/mpb", {"uploads": ""})
        if _xml_text(b, "UploadId") != [pending]:
            fail(f"S3 mp phase: ListMultipartUploads {_xml_text(b, 'UploadId')}")
        req("DELETE", "/mpb/pending", {"uploadId": pending}, want=204)
        _h, b = req("GET", "/mpb", {"uploads": ""})
        if _xml_text(b, "UploadId"):
            fail("S3 mp phase: the aborted upload is still listed")
        for r in roots:
            if os.path.exists(os.path.join(r, ".sys", "multipart", pending)):
                fail(f"S3 mp phase: the aborted upload's dir remains on {r}")

        # -- 3. reading multipart objects, healthy and degraded
        sha = {k: hashlib.sha256(v).digest() for k, v in objs.items()}

        def get(signer, key):
            st, _h, body = signer.request("GET", f"/mpb/{key}")
            if st != 200 or hashlib.sha256(body).digest() != sha[key]:
                fail(f"S3 mp phase: GET {key}: {st}, body differs from its source")
            return len(body)

        keys = sorted(objs)
        get_jobs = [keys[c::S3_CLIENTS] for c in range(S3_CLIENTS)]
        lo = MP_PART - 100
        rng_hdr = {"range": f"bytes={lo}-{MP_PART + 99}"}

        def ranged(what):
            st, _h, got = one.request("GET", "/mpb/mp1", headers=rng_hdr)
            if st != 206 or got != objs["mp1"][lo:MP_PART + 100]:
                fail(f"S3 mp phase: {what} ranged GET across a part boundary: {st}")

        get_wall, sizes = _in_clients(host, port, get_jobs, get)
        ranged("healthy")
        dist = XLStorage(roots[0]).read_version("mpb", "mp-small").erasure.distribution
        dead = sorted(d for d in range(N) if dist[d] in MP_SHARDS_OFF)
        live = list(ol.disks)
        for d in dead:
            ol.disks[d] = None
        try:
            ld = launched()
            deg_wall, _ = _in_clients(host, port, get_jobs, get)
            ranged("degraded")
            deg_launch = delta(ld, launched())
            if deg_launch.get("gf_matmul_words", 0) <= 0:
                fail("S3 mp phase: the degraded GETs reconstructed nothing")
        finally:
            ol.disks[:] = live
        nget = sum(sizes)

        # -- 4. copies: UploadPartCopy, CopyObject, self-copy
        lcp = launched()
        t0 = time.monotonic()
        _h, b = req("POST", "/mpb/assembled", {"uploads": ""})
        asm = _xml_text(b, "UploadId")[0]
        # 7 MiB across mp2's first part boundary, mp-small's first 5 MiB
        r1 = (MP_PART // 2, MP_PART // 2 + MP_MIN_PART + MP_PART // 4 - 1)
        r2 = (0, MP_MIN_PART - 1)
        tail = rng.bytes(MP_PART // 8)
        asm_parts = [objs["mp2"][r1[0]:r1[1] + 1],
                     objs["mp-small"][r2[0]:r2[1] + 1], tail]
        for n, (src, r) in enumerate((("mp2", r1), ("mp-small", r2)), 1):
            _h, b = req("PUT", "/mpb/assembled",
                        {"partNumber": str(n), "uploadId": asm},
                        headers={"x-amz-copy-source": f"/mpb/{src}",
                                 "x-amz-copy-source-range": f"bytes={r[0]}-{r[1]}"},
                        what=f"UploadPartCopy {n}")
            if _xml_text(b, "ETag")[0].strip('"') != hashlib.md5(
                    asm_parts[n - 1]).hexdigest():
                fail(f"S3 mp phase: UploadPartCopy {n} ETag")
        req("PUT", "/mpb/assembled", {"partNumber": "3", "uploadId": asm}, tail)
        _h, b = req("POST", "/mpb/assembled", {"uploadId": asm},
                    _complete_body([hashlib.md5(p).hexdigest()
                                    for p in asm_parts]))
        upc_wall = time.monotonic() - t0
        asm_body = b"".join(asm_parts)
        _h, got = req("GET", "/mpb/assembled")
        if got != asm_body:
            fail("S3 mp phase: the UploadPartCopy object differs from its ranges")
        t0 = time.monotonic()
        _h, b = req("PUT", "/mpb/copy-mp3",
                    headers={"x-amz-copy-source": "/mpb/mp3"},
                    what="CopyObject")
        copy_wall = time.monotonic() - t0
        _h, got = req("GET", "/mpb/copy-mp3")
        if hashlib.sha256(got).digest() != sha["mp3"]:
            fail("S3 mp phase: the CopyObject copy differs from its source")
        kib = rng.bytes(1024)
        req("PUT", "/mpb/kib", body=kib, headers={"x-amz-meta-v": "1"})
        req("PUT", "/mpb/kib", headers={
            "x-amz-copy-source": "/mpb/kib",
            "x-amz-metadata-directive": "REPLACE", "x-amz-meta-v": "2"},
            what="self-copy")
        h, got = req("GET", "/mpb/kib")
        if got != kib or h.get("x-amz-meta-v") != "2":
            fail(f"S3 mp phase: self-copy gave {h.get('x-amz-meta-v')!r}")
        copy_launch = delta(lcp, launched())
        for name in ("phash256_batched", "encode_pack_pipelined"):
            if copy_launch.get(name, 0) <= 0:
                fail(f"S3 mp phase: the copies never launched {name}")

        # -- 5. heal a multipart object
        hdist = XLStorage(roots[0]).read_version("mpb", "mp0").erasure.distribution
        hurt = sorted(d for d in range(N) if hdist[d] in MP_SHARDS_OFF)
        saved = {}
        for d in hurt:
            fi = XLStorage(roots[d]).read_version("mpb", "mp0")
            ddir = os.path.join(roots[d], "mpb", "mp0", fi.data_dir)
            for name in sorted(os.listdir(ddir)):
                with open(os.path.join(ddir, name), "rb") as f:
                    saved[(d, name)] = f.read()
                os.remove(os.path.join(ddir, name))
        lh = launched()
        t0 = time.monotonic()
        res = ol.heal_object("mpb", "mp0")
        heal_s = time.monotonic() - t0
        heal_launch = delta(lh, launched())
        want = sorted(s - 1 for s in MP_SHARDS_OFF)
        if res["healed"] != want:
            fail(f"S3 mp phase: heal_object healed {res['healed']}, want {want}")
        for name in ("verify_reconstruct_pipelined", "encode_pack[group=0]"):
            if heal_launch.get(name, 0) <= 0:
                fail(f"S3 mp phase: heal never launched {name}")
        for (d, name), data in saved.items():
            fi = XLStorage(roots[d]).read_version("mpb", "mp0")
            with open(os.path.join(roots[d], "mpb", "mp0", fi.data_dir, name),
                      "rb") as f:
                if f.read() != data:
                    fail(f"S3 mp phase: healed {name} on disk {d} differs")
        others = [d for d in range(N) if d not in hurt][:4]
        for d in others:
            ol.disks[d] = None
        try:
            get(one, "mp0")
        finally:
            ol.disks[:] = live

        # -- 6. versions, POST policy, multi-delete
        req("PUT", "/mpver", what="versioned bucket create")
        req("PUT", "/mpver", {"versioning": ""},
            b"<VersioningConfiguration><Status>Enabled</Status>"
            b"</VersioningConfiguration>")
        req("PUT", "/mpver/k", body=b"v1")
        req("PUT", "/mpver/k", body=b"v2-longer")
        req("DELETE", "/mpver/k", want=204)
        seen, km, vm = [], "", ""
        for _ in range(10):
            q = {"versions": "", "max-keys": "1"}
            if km:
                q.update({"key-marker": km, "version-id-marker": vm})
            _h, b = req("GET", "/mpver", q)
            root = ET.fromstring(b)
            ns = root.tag[: root.tag.index("}") + 1]
            for e in root:
                if e.tag in (f"{ns}Version", f"{ns}DeleteMarker"):
                    seen.append((e.tag[len(ns):], e.findtext(f"{ns}IsLatest"),
                                 e.findtext(f"{ns}Size")))
            if root.findtext(f"{ns}IsTruncated") != "true":
                break
            km = root.findtext(f"{ns}NextKeyMarker")
            vm = root.findtext(f"{ns}NextVersionIdMarker")
        want_v = [("DeleteMarker", "true", None), ("Version", "false", "9"),
                  ("Version", "false", "2")]
        if seen != want_v:
            fail(f"S3 mp phase: ListObjectVersions paged {seen} != {want_v}")
        form_data = rng.bytes(3000)
        body, ctype = _post_policy_form(one, "mpb", "posted", form_data)
        req("POST", "/mpb", body=body, headers={"content-type": ctype},
            anonymous=True, want=204, what="POST policy upload")
        _h, got = req("GET", "/mpb/posted")
        if got != form_data:
            fail("S3 mp phase: the POST-policy object differs from the form's")
        _h, b = req("GET", "/mpb", {"list-type": "2"})
        all_keys = _xml_text(b, "Key")
        dbody = ("<Delete><Quiet>true</Quiet>" + "".join(
            f"<Object><Key>{k}</Key></Object>" for k in all_keys)
            + "</Delete>").encode()
        _h, b = req("POST", "/mpb", {"delete": ""}, dbody, what="multi-delete")
        if _xml_text(b, "Key"):
            fail(f"S3 mp phase: quiet multi-delete answered {b[:300]!r}")
        for k in all_keys:
            req("GET", f"/mpb/{k}", want=404, what=f"GET {k} after multi-delete")
        phase_s = time.monotonic() - t_phase
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        stats = KERNEL_STATS.snapshot()
    finally:
        one.close()
        srv.shutdown()
        for r in roots:
            shutil.rmtree(r, ignore_errors=True)

    nput = sum(len(objs[f"mp{c}"]) for c in range(S3_CLIENTS))
    batch = stats["batch"]
    out = {
        "clients": S3_CLIENTS,
        "objects": len(objs),
        "parts": nparts + 3,
        "phase_s": phase_s,
        "mp_put_concurrent": {"bytes": nput, "s": put_wall,
                              "MBps": nput / put_wall / 1e6,
                              "parts": nparts, "k5_launches": k5,
                              "batch": put_batch},
        "complete_s": complete_s,
        "get_concurrent": {"bytes": nget, "s": get_wall,
                           "MBps": nget / get_wall / 1e6},
        "get_degraded_concurrent": {"bytes": nget, "s": deg_wall,
                                    "MBps": nget / deg_wall / 1e6,
                                    "offline_disks": dead},
        "copy_object": {"bytes": len(objs["mp3"]), "s": copy_wall,
                        "MBps": len(objs["mp3"]) / copy_wall / 1e6},
        "upload_part_copy": {"bytes": len(asm_body), "s": upc_wall,
                             "MBps": len(asm_body) / upc_wall / 1e6},
        "heal_object_s": heal_s,
        "short_writes": short,
        "launches": launches,
        "launches_by_step": {"part_puts": put_launch, "small_upload": small_launch,
                             "repair": repair_launch,
                             "get_degraded": deg_launch, "copies": copy_launch,
                             "heal": heal_launch},
        "flushes": {"multi_client": batch["multi_client_flushes"],
                    "total": batch["flushes"], "jobs": batch["jobs"]},
        "stages": stats["stages"],
    }
    return out


# -- phase 8b: server-side encryption and compression ------------------------

SSE_RANGES = ((65_436, 200), (10_485_660, 200))  # and each object's last 17 B
SSE_S3_OBJECTS = 4
SSE_MP_PARTS = 4  # x MP_PART
SSE_CONFIG = (
    b"<ServerSideEncryptionConfiguration><Rule>"
    b"<ApplyServerSideEncryptionByDefault><SSEAlgorithm>AES256</SSEAlgorithm>"
    b"</ApplyServerSideEncryptionByDefault></Rule>"
    b"</ServerSideEncryptionConfiguration>")


def tls_cert(work: str) -> "tuple[str, str]":
    """(certificate, key) PEM files of a self-signed certificate for
    127.0.0.1 (CN and IP SAN), from the openssl CLI."""
    cert, key = os.path.join(work, "tls-cert.pem"), os.path.join(work, "tls-key.pem")
    r = subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-keyout", key,
         "-out", cert, "-days", "1", "-nodes", "-subj", "/CN=127.0.0.1",
         "-addext", "subjectAltName=IP:127.0.0.1"],
        capture_output=True, text=True)
    if r.returncode != 0:
        fail(f"sse: openssl req failed: {r.stderr[-300:]}")
    return cert, key


def ssec_headers(key: bytes, copy_source: bool = False) -> dict:
    """The SSE-C header triplet (or its copy-source form) for ``key``."""
    import base64
    import hashlib

    p = ("x-amz-copy-source-server-side-encryption-customer" if copy_source
         else "x-amz-server-side-encryption-customer")
    return {f"{p}-algorithm": "AES256",
            f"{p}-key": base64.b64encode(key).decode(),
            f"{p}-key-MD5": base64.b64encode(hashlib.md5(key).digest()).decode()}


def host_transform_rates(plain: bytes, text: bytes) -> dict:
    """MB/s of EncryptReader, DecryptWriter, CompressReader and
    DecompressWriter alone, each over its 64 MiB input in memory, pulled
    and pushed in 10 MiB steps as the codec moves blocks."""
    from minio_tpu_torch.codec import compress as compmod, sse as ssemod

    class Sink:
        n = 0

        def write(self, b):
            Sink.n += len(b)

    def pull(reader) -> bytes:
        out = []
        while True:
            got = reader.read(BLOCK)
            if not got:
                return b"".join(out)
            out.append(got)

    def push(writer, data) -> None:
        for i in range(0, len(data), BLOCK):
            writer.write(data[i:i + BLOCK])
        writer.finish()

    key, nb = bytes(range(32)), bytes(8)
    out = {}
    t = time.monotonic()
    sealed = pull(ssemod.EncryptReader(io.BytesIO(plain), key, nb))
    out["encrypt_MBps"] = len(plain) / (time.monotonic() - t) / 1e6
    Sink.n = 0
    t = time.monotonic()
    push(ssemod.DecryptWriter(Sink(), key, nb), sealed)
    out["decrypt_MBps"] = len(plain) / (time.monotonic() - t) / 1e6
    if Sink.n != len(plain):
        fail(f"sse: DecryptWriter gave {Sink.n} of {len(plain)} bytes")
    t = time.monotonic()
    deflated = pull(compmod.CompressReader(io.BytesIO(text)))
    out["compress_MBps"] = len(text) / (time.monotonic() - t) / 1e6
    Sink.n = 0
    t = time.monotonic()
    push(compmod.DecompressWriter(Sink()), deflated)
    out["decompress_MBps"] = len(text) / (time.monotonic() - t) / 1e6
    if Sink.n != len(text):
        fail(f"sse: DecompressWriter gave {Sink.n} of {len(text)} bytes")
    out["text_ratio"] = len(deflated) / len(text)
    return out


def sse_phase(dev, work: str, s3: dict) -> dict:
    """Phase 8b (slice 8): SSE-C, SSE-S3 and compression through the
    port's S3Server (threaded plane, TLS) over a fresh ErasureObjects on
    the card (12 disks, EC 8+4, 10 MiB blocks), 4 SigV4 clients."""
    import hashlib
    import json as _json

    import numpy as np

    from minio_tpu_torch.codec import kms as kmsmod, sse as ssemod
    from minio_tpu_torch.codec.telemetry import KERNEL_STATS
    from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
    from minio_tpu_torch.ops import kernels
    from minio_tpu_torch.s3select.engine import S3Select, SelectRequest
    from minio_tpu_torch.server.http import S3Server
    from minio_tpu_torch.storage.xl import XLStorage

    # the AEAD route: cryptography's AES-256-GCM, or SSE cannot run here
    if ssemod._CRYPTO_IMPORT_ERROR is not None:
        fail(f"sse: no AEAD: {ssemod._CRYPTO_IMPORT_ERROR}")
    import cryptography

    route = f"cryptography {cryptography.__version__} AESGCM"
    rng = np.random.default_rng(SEED + 8)
    master = rng.bytes(32)
    ckey, wrong = rng.bytes(32), rng.bytes(32)
    cert, tkey = tls_cert(work)
    env = {"MINIO_TPU_TLS": "on", "MINIO_TPU_CERT_FILE": cert,
           "MINIO_TPU_KEY_FILE": tkey,
           "MINIO_TPU_KMS_MASTER_KEY": "chip-smoke:" + master.hex()}
    saved = {k: os.environ.get(k) for k in (*env, "MINIO_TPU_COMPRESS")}
    os.environ.update(env)
    os.environ.pop("MINIO_TPU_COMPRESS", None)
    kmsmod.reset_kms_cache()
    roots = [os.path.join(work, f"ssedisk{i}") for i in range(N)]
    ol = ErasureObjects([XLStorage(r) for r in roots], parity_blocks=M,
                        block_size=BLOCK)
    srv = S3Server(ol, address="127.0.0.1:0").start()
    host, port = srv.host, srv.port
    if srv.server_mode != "threaded" or not srv.tls:
        fail(f"sse: server plane {srv.server_mode}, tls {srv.tls}")
    t0 = time.monotonic()
    objs = {f"c{c}/o{j}": rng.bytes(S3_BIG)
            for c in range(S3_CLIENTS) for j in range(2)}
    sha = {k: hashlib.sha256(v).digest() for k, v in objs.items()}
    text = lineitem_csv(SEED + 8, S3_BIG)
    rows = text.split(b"\n")[1:-1]
    # four 64 MiB lineitem objects: the same rows, rotated by a quarter
    texts = [b"\n".join([LI_HEADER.encode()] + rows[i * len(rows) // 4:]
                        + rows[:i * len(rows) // 4]) + b"\n" for i in range(4)]
    make_s = time.monotonic() - t0
    hdr = ssec_headers(ckey)
    one = S3Signer(host, port, cafile=cert)
    out: dict = {"aead": route, "tls": True, "make_s": make_s}

    def check(st, body, want, what):
        if st != want:
            fail(f"sse: {what}: {st} {body[:300]!r}")

    def launched_since(before: dict) -> dict:
        return {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v != before[k]}

    try:
        kernels.reset_launches()
        KERNEL_STATS.reset()
        t_phase = time.monotonic()
        # 0. the same server's TLS without SSE: one plain 64 MiB object
        # a client, PUT then GET, the baseline the SSE sub-phases stand by
        st, _h, body = one.request("PUT", "/plain")
        check(st, body, 200, "bucket create")
        pjobs = [[f"c{c}/o0"] for c in range(S3_CLIENTS)]

        def put_p(signer, key):
            st, _h, body = signer.request("PUT", f"/plain/{key}", body=objs[key],
                                          payload_hash=sha[key].hex())
            check(st, body, 200, f"TLS PUT {key}")
            return key

        def get_p(signer, key):
            st, _h, body = signer.request("GET", f"/plain/{key}")
            if st != 200 or hashlib.sha256(body).digest() != sha[key]:
                fail(f"sse: TLS GET {key}: {st}, body differs from its source")
            return key

        nplain = S3_BIG * len(pjobs)
        pput_wall, _ = _in_clients(host, port, pjobs, put_p, cert)
        pget_wall, _ = _in_clients(host, port, pjobs, get_p, cert)
        out["tls_plain"] = {
            "objects": len(pjobs), "bytes": nplain,
            "put": {"s": pput_wall, "MBps": nplain / pput_wall / 1e6},
            "get": {"s": pget_wall, "MBps": nplain / pget_wall / 1e6},
        }
        # a. SSE-C: 4 clients, two 64 MiB objects each, PUT then GET
        st, _h, body = one.request("PUT", "/ssec")
        check(st, body, 200, "bucket create")
        jobs = [[f"c{c}/o{j}" for j in range(2)] for c in range(S3_CLIENTS)]

        def put_c(signer, key):
            st, h, body = signer.request("PUT", f"/ssec/{key}", body=objs[key],
                                         headers=hdr, payload_hash=sha[key].hex())
            check(st, body, 200, f"SSE-C PUT {key}")
            if h.get("x-amz-server-side-encryption-customer-algorithm") != "AES256":
                fail(f"sse: SSE-C PUT {key} answered headers {h}")
            return key

        def get_c(signer, key):
            st, _h, body = signer.request("GET", f"/ssec/{key}", headers=hdr)
            if st != 200 or hashlib.sha256(body).digest() != sha[key]:
                fail(f"sse: SSE-C GET {key}: {st}, body differs from its source")
            return len(body)

        def ranges_c(signer, key):
            size = len(objs[key])
            for lo, n in (*SSE_RANGES, (size - 17, 17)):
                st, _h, body = signer.request("GET", f"/ssec/{key}", headers={
                    **hdr, "range": f"bytes={lo}-{lo + n - 1}"})
                if st != 206 or body != objs[key][lo:lo + n]:
                    fail(f"sse: SSE-C range {lo}+{n} of {key}: {st}")
            return key

        nobj = sum(map(len, objs.values()))
        put_wall, _ = _in_clients(host, port, jobs, put_c, cert)
        get_wall, _ = _in_clients(host, port, jobs, get_c, cert)
        range_wall, _ = _in_clients(host, port, jobs, ranges_c, cert)
        fi = XLStorage(roots[0]).read_version("ssec", "c0/o0")
        if (fi.metadata.get(ssemod.META_SSE) != "C"
                or fi.size != ssemod.stored_size(S3_BIG)):
            fail(f"sse: c0/o0 stored {fi.size} B with {fi.metadata}")
        dist = fi.erasure.distribution
        dead = sorted(d for d in range(N) if dist[d] in (1, 3, 10, 12))
        live = list(ol.disks)
        before = dict(kernels.LAUNCHES)
        for d in dead:
            ol.disks[d] = None
        try:
            t = time.monotonic()
            get_c(one, "c0/o0")
            deg_s = time.monotonic() - t
        finally:
            ol.disks[:] = live
        deg_launch = launched_since(before)
        if not deg_launch.get("gf_matmul_words"):
            fail(f"sse: the degraded SSE-C GET reconstructed nothing: {deg_launch}")
        st, _h, body = one.request("GET", "/ssec/c0/o0", headers=ssec_headers(wrong))
        check(st, body, 403, "GET with a wrong key")
        if b"<Code>AccessDenied</Code>" not in body:
            fail(f"sse: a wrong key answered {body[:200]!r}")
        st, _h, body = one.request("GET", "/ssec/c0/o0")
        check(st, body, 400, "GET without the key")
        out["ssec"] = {
            "objects": len(objs), "bytes": nobj,
            "put": {"s": put_wall, "MBps": nobj / put_wall / 1e6},
            "get": {"s": get_wall, "MBps": nobj / get_wall / 1e6},
            "ranges": {"s": range_wall, "count": 3 * len(objs)},
            "get_degraded_one": {"s": deg_s, "MBps": S3_BIG / deg_s / 1e6,
                                 "offline_disks": dead, "launches": deg_launch},
            "stored_over_actual": fi.size / S3_BIG,
        }

        # b. SSE-S3 by the bucket's default rule: no header on the PUTs
        st, _h, body = one.request("PUT", "/sses3")
        check(st, body, 200, "bucket create")
        st, _h, body = one.request("PUT", "/sses3", {"encryption": ""}, SSE_CONFIG)
        check(st, body, 200, "PUT ?encryption")
        st, _h, body = one.request("GET", "/sses3", {"encryption": ""})
        check(st, body, 200, "GET ?encryption")
        keys3 = sorted(objs)[:SSE_S3_OBJECTS]
        jobs3 = [[k] for k in keys3]

        def put_s3(signer, key):
            st, h, body = signer.request("PUT", f"/sses3/{key}", body=objs[key],
                                         payload_hash=sha[key].hex())
            check(st, body, 200, f"SSE-S3 PUT {key}")
            if h.get("x-amz-server-side-encryption") != "AES256":
                fail(f"sse: SSE-S3 PUT {key} answered headers {h}")
            return key

        def get_s3(signer, key):
            st, h, body = signer.request("GET", f"/sses3/{key}")
            if (st != 200 or hashlib.sha256(body).digest() != sha[key]
                    or h.get("x-amz-server-side-encryption") != "AES256"):
                fail(f"sse: SSE-S3 GET {key}: {st} {h}")
            return key

        n3 = S3_BIG * len(keys3)
        put3_wall, _ = _in_clients(host, port, jobs3, put_s3, cert)
        get3_wall, _ = _in_clients(host, port, jobs3, get_s3, cert)
        st, _h, body = one.request("GET", f"{ADMIN}/kms/key/status")
        check(st, body, 200, "admin kms/key/status")
        status = _json.loads(body)
        if (status.get("encryption"), status.get("decryption")) != ("success", "success"):
            fail(f"sse: kms/key/status {status}")
        meta3 = XLStorage(roots[0]).read_version("sses3", keys3[0]).metadata
        if meta3.get(ssemod.META_SSE) != "S3" or meta3.get(ssemod.META_SSE_KMS_ID) != "chip-smoke":
            fail(f"sse: the bucket default stored {meta3}")
        out["sses3"] = {
            "objects": len(keys3), "bytes": n3,
            "put": {"s": put3_wall, "MBps": n3 / put3_wall / 1e6},
            "get": {"s": get3_wall, "MBps": n3 / get3_wall / 1e6},
            "kms_key_status": status,
        }

        # c. compression: 4 x 64 MiB of lineitem text, one more sealed too
        os.environ["MINIO_TPU_COMPRESS"] = "on"
        st, _h, body = one.request("PUT", "/zip")
        check(st, body, 200, "bucket create")
        zjobs = [[(f"li{i}.csv", i)] for i in range(4)]

        def put_z(signer, job):
            key, i = job
            st, _h, body = signer.request("PUT", f"/zip/{key}", body=texts[i])
            check(st, body, 200, f"compressed PUT {key}")
            return key

        def get_z(signer, job):
            key, i = job
            st, _h, body = signer.request("GET", f"/zip/{key}")
            if st != 200 or body != texts[i]:
                fail(f"sse: compressed GET {key}: {st}, body differs")
            return key

        nz = sum(map(len, texts))
        zput_wall, _ = _in_clients(host, port, zjobs, put_z, cert)
        zget_wall, _ = _in_clients(host, port, zjobs, get_z, cert)
        t = time.monotonic()
        st, _h, body = one.request("PUT", "/zip/li_ssec.csv", body=texts[0],
                                   headers=hdr)
        zc_put_s = time.monotonic() - t
        check(st, body, 200, "compressed+SSE-C PUT")
        stored = {k: XLStorage(roots[0]).read_version("zip", k)
                  for k in ("li0.csv", "li_ssec.csv")}
        for k, f in stored.items():
            if (f.metadata.get("x-internal-compression") != "deflate/v1"
                    or int(f.metadata["x-internal-actual-size"]) != len(texts[0])):
                fail(f"sse: {k} stored with {f.metadata}")
        if stored["li_ssec.csv"].metadata.get(ssemod.META_SSE) != "C":
            fail("sse: li_ssec.csv was not sealed")
        lo = BLOCK + 12_345
        for key, h in (("li0.csv", {}), ("li_ssec.csv", hdr)):
            st, _h, body = one.request("GET", f"/zip/{key}", headers={
                **h, "range": f"bytes={lo}-{lo + 99_999}"})
            if st != 206 or body != texts[0][lo:lo + 100_000]:
                fail(f"sse: compressed range GET of {key}: {st}")
        os.environ.pop("MINIO_TPU_COMPRESS", None)
        # Select Q1 over the compressed and the sealed object, against
        # the host engine's Records over the plain text
        qbody = select_body(SELECT_QUERIES["Q1"])
        os.environ["MINIO_TPU_SELECT"] = "host"
        try:
            spool = io.BytesIO()
            t = time.monotonic()
            S3Select(SelectRequest.from_xml(qbody), dev).evaluate(
                io.BytesIO(texts[0]), len(texts[0]), spool.write)
            host_q1_s = time.monotonic() - t
        finally:
            os.environ.pop("MINIO_TPU_SELECT", None)
        want, _k = select_records(spool.getvalue())
        sel = {"host_plain_s": host_q1_s, "rows": want.count(b"\n")}
        for key, h in (("li0.csv", {}), ("li_ssec.csv", hdr)):
            before = dict(kernels.LAUNCHES)
            t = time.monotonic()
            st, _h, body = one.request("POST", f"/zip/{key}",
                                       {"select": "", "select-type": "2"}, qbody,
                                       headers=h)
            took = time.monotonic() - t
            check(st, body, 200, f"Select Q1 over {key}")
            recs, _k = select_records(body)
            if recs != want or not recs:
                fail(f"sse: Q1 over {key} answered {len(recs)} B, the host "
                     f"engine {len(want)} B")
            sel[key] = {"s": took, "launches": launched_since(before)}
            if not sel[key]["launches"].get("select_screen"):
                fail(f"sse: Q1 over {key} launched {sel[key]['launches']}")
        sizes = {k: (f.size, len(texts[0])) for k, f in stored.items()}
        out["compress"] = {
            "objects": 4, "bytes": nz,
            "put": {"s": zput_wall, "MBps": nz / zput_wall / 1e6},
            "get": {"s": zget_wall, "MBps": nz / zget_wall / 1e6},
            "ssec_put_one": {"s": zc_put_s, "MBps": len(texts[0]) / zc_put_s / 1e6},
            "stored_over_actual": {k: a / b for k, (a, b) in sizes.items()},
            "select_Q1": sel,
        }

        # d. SSE-C multipart: 4 x 8 MiB parts, Complete, a GET across parts
        parts = [objs["c1/o1"][i * MP_PART:(i + 1) * MP_PART]
                 for i in range(SSE_MP_PARTS)]
        whole = b"".join(parts)
        t = time.monotonic()
        st, _h, body = one.request("POST", "/ssec/mp", {"uploads": ""}, headers=hdr)
        check(st, body, 200, "initiate SSE-C upload")
        uid = _xml_text(body, "UploadId")[0]
        etags = []
        for n, data in enumerate(parts, 1):
            st, h, body = one.request("PUT", "/ssec/mp",
                                      {"partNumber": str(n), "uploadId": uid},
                                      body=data, headers=hdr)
            check(st, body, 200, f"SSE-C part {n}")
            etags.append(h["etag"].strip('"'))
        st, _h, body = one.request("POST", "/ssec/mp", {"uploadId": uid},
                                   _complete_body(etags))
        check(st, body, 200, "Complete of the SSE-C upload")
        mp_s = time.monotonic() - t
        lo = MP_PART - 100
        st, _h, body = one.request("GET", "/ssec/mp", headers={
            **hdr, "range": f"bytes={lo}-{lo + 199}"})
        if st != 206 or body != whole[lo:lo + 200]:
            fail(f"sse: GET across the SSE-C upload's part boundary: {st}")
        st, _h, body = one.request("GET", "/ssec/mp", headers=hdr)
        if st != 200 or body != whole:
            fail(f"sse: GET of the SSE-C upload: {st}")
        mpmeta = XLStorage(roots[0]).read_version("ssec", "mp").metadata
        if mpmeta.get(ssemod.META_SSE_PARTS) != "1,2,3,4":
            fail(f"sse: the upload stored {mpmeta}")
        out["multipart"] = {"parts": len(parts), "bytes": len(whole),
                            "s": mp_s, "MBps": len(whole) / mp_s / 1e6}

        # e. CopyObject SSE-C -> SSE-S3, then heal of an SSE-C object
        t = time.monotonic()
        st, _h, body = one.request("PUT", "/sses3/copied", headers={
            "x-amz-copy-source": "/ssec/c2/o0", **ssec_headers(ckey, True),
            "x-amz-server-side-encryption": "AES256"})
        copy_s = time.monotonic() - t
        check(st, body, 200, "CopyObject SSE-C -> SSE-S3")
        st, h, body = one.request("GET", "/sses3/copied")
        if (st != 200 or hashlib.sha256(body).digest() != sha["c2/o0"]
                or h.get("x-amz-server-side-encryption") != "AES256"):
            fail(f"sse: GET of the copy: {st} {h}")
        hfi = XLStorage(roots[0]).read_version("ssec", "c3/o1")
        victim = hfi.erasure.distribution.index(1)  # the disk of shard 1
        before_files = part_files(roots[victim], "ssec", "c3/o1")
        shutil.rmtree(os.path.join(roots[victim], "ssec", "c3", "o1"))
        before = dict(kernels.LAUNCHES)
        t = time.monotonic()
        healed = ol.heal_object("ssec", "c3/o1")
        heal_s = time.monotonic() - t
        heal_launch = launched_since(before)
        for name in ("verify_reconstruct_pipelined", "encode_pack[group=0]"):
            if not heal_launch.get(name):
                fail(f"sse: heal launched {heal_launch}, no {name}")
        if healed.get("healed") != [0] or part_files(
                roots[victim], "ssec", "c3/o1") != before_files:
            fail(f"sse: heal of c3/o1 {healed}: the part file differs")
        get_c(one, "c3/o1")
        out["copy"] = {"bytes": S3_BIG, "s": copy_s, "MBps": S3_BIG / copy_s / 1e6}
        out["heal"] = {"s": heal_s, "launches": heal_launch}
        out["phase_s"] = time.monotonic() - t_phase
        launches = dict(kernels.LAUNCHES)
        stats = KERNEL_STATS.snapshot()
    finally:
        one.close()
        srv.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        kmsmod.reset_kms_cache()
        for r in roots:
            shutil.rmtree(r, ignore_errors=True)
    for name in ("encode_pack_pipelined", "phash256_batched", "gf_matmul_words",
                 "verify_reconstruct_pipelined", "encode_pack[group=0]",
                 "select_screen", "select_positions", "select_spans[row]"):
        if launches[name] <= 0:
            fail(f"sse: kernel {name} never launched")
    # K1 runs only as heal's re-encode (group=0; its launches count
    # under both names), and no mxu kernel runs
    if launches["encode_pack"] != launches["encode_pack[group=0]"]:
        fail(f"sse: K1 launched with the pack leg: {launches}")
    if launches["encode_pack_pipelined[mxu]"]:
        fail("sse: kernel encode_pack_pipelined[mxu] launched")
    out["plain_s3_MBps"] = {"put": s3["put_concurrent"]["MBps"],
                            "get": s3["get_concurrent"]["MBps"]}
    out["host_alone"] = host_transform_rates(objs["c0/o0"], texts[0])
    out["stages"] = stats["stages"]
    out["launches"] = {k: v for k, v in launches.items() if v}
    return out


# -- phase 10: the server as users start it -----------------------------------

BOOT_DRIVES = 24  # two EC 8+4 sets
BOOT_SPEC = "disk{1...24}"
BOOT_WIPE_LIVE = 5  # drive of set 0, wiped while the server runs
BOOT_WIPE_DOWN = 17  # drive of set 1, wiped while it is down
BOOT_READY_S = 300.0  # spawn to ready, CUDA start and library load included
BOOT_HEAL_S = 180.0
ADMIN = "/minio-tpu/admin/v1"


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _drive_files(root: str, bucket: str) -> dict:
    """{path under the bucket: sha256} of every file one drive holds for
    the bucket (xl.meta and part files), read straight from the disk."""
    import hashlib

    out = {}
    base = os.path.join(root, bucket)
    for dirpath, _dirs, files in os.walk(base):
        for name in files:
            path = os.path.join(dirpath, name)
            try:
                with open(path, "rb") as f:
                    out[os.path.relpath(path, base)] = hashlib.sha256(
                        f.read()).hexdigest()
            except OSError:
                continue
    return out


def _wipe_drive(root: str) -> None:
    """A replaced drive: the mount point stays, its contents are gone."""
    for entry in os.listdir(root):
        path = os.path.join(root, entry)
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        else:
            os.remove(path)


class _BootedServer:
    """``python -m minio_tpu_torch.server`` in a process of its own (never
    a fork of this one, which holds a CUDA context); its output goes to a
    log file read back at the end.  ``drives`` is the drive argument (the
    boot phase's 24 by default); ``what`` names the phase in failures."""

    def __init__(self, work: str, port: int, env: dict, tag: str,
                 drives: "str | list | None" = None, what: str = "boot phase",
                 cafile: "str | None" = None):
        self.port = port
        self.what = what
        self.cafile = cafile  # a TLS server's certificate
        self.log_path = os.path.join(work, f"server-{tag}.log")
        self._log = open(self.log_path, "w")
        here = os.path.dirname(os.path.abspath(__file__))
        if not isinstance(drives, list):
            drives = [drives or os.path.join(work, "boot", BOOT_SPEC)]
        self.t_spawn = time.monotonic()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "minio_tpu_torch.server", "--parity",
             str(M), "--address", f"127.0.0.1:{port}", *drives],
            cwd=here, env=env, stdout=self._log, stderr=subprocess.STDOUT)

    def wait_ready(self) -> float:
        """Seconds from spawn until /minio/health/ready answers 200."""
        import http.client

        deadline = self.t_spawn + BOOT_READY_S
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                fail(f"{self.what}: the server exited {self.proc.returncode}: "
                     f"{self.output()[-2000:]}")
            try:
                if self.cafile:
                    import ssl

                    conn = http.client.HTTPSConnection(
                        "127.0.0.1", self.port, timeout=5,
                        context=ssl.create_default_context(cafile=self.cafile))
                else:
                    conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                                      timeout=5)
                conn.request("GET", "/minio/health/ready")
                status = conn.getresponse().status
                conn.close()
                if status == 200:
                    return time.monotonic() - self.t_spawn
            except OSError:
                pass
            time.sleep(0.05)
        fail(f"{self.what}: not ready within {BOOT_READY_S} s")

    def output(self) -> str:
        self._log.flush()
        with open(self.log_path) as f:
            return f.read()

    def sigterm(self, last: str = "shutdown complete") -> float:
        """SIGTERM; seconds until the process exits (0 expected) with
        ``last`` as its last line (a gateway's: the signal's)."""
        import signal

        t0 = time.monotonic()
        self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            self.kill()
            fail(f"{self.what}: the server did not exit on SIGTERM")
        took = time.monotonic() - t0
        out = self.output()
        if rc != 0 or last not in out.splitlines()[-1:]:
            fail(f"{self.what}: SIGTERM exit {rc}: {out[-2000:]}")
        return took

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)
        self._log.close()


def boot_phase(work: str, payloads: list, backend: "str | None" = None) -> dict:
    """Phase 10: the port's real entry point.  ``python -m
    minio_tpu_torch.server --parity 4`` over 24 temp-dir drives (two EC
    8+4 sets, 10 MiB blocks) on the async plane and the card (neither
    MINIO_TPU_SERVER nor MINIO_ERASURE_BACKEND set; ``backend`` sets the
    latter for a rehearsal on the CPU), the fresh-disk monitor every
    second.  Boot, traffic of 4 SigV4 clients, a drive wiped while the
    server runs and healed back, an admin heal, SIGTERM, then a restart
    over the same drives with another drive wiped while it was down."""
    import hashlib
    import json as _json

    import numpy as np

    from minio_tpu_torch.objectlayer.sets import crc_hash_mod

    roots = [os.path.join(work, "boot", f"disk{i}")
             for i in range(1, BOOT_DRIVES + 1)]
    per_set = BOOT_DRIVES // 2
    env = {k: v for k, v in os.environ.items()
           if k not in ("MINIO_TPU_SERVER", "MINIO_ERASURE_BACKEND")}
    env["MINIO_TPU_FRESH_DISK_INTERVAL_S"] = "1"
    env["MINIO_TPU_LOG_LEVEL"] = "warning"
    if backend is not None:
        env["MINIO_ERASURE_BACKEND"] = backend
    rng = np.random.default_rng(SEED + 9)
    objs = {f"c{c}/big{j}": rng.bytes(S3_BIG)
            for c in range(S3_CLIENTS) for j in range(2)}
    objs["obj4"] = payloads[4]  # the 10 MiB + 17 B object
    sha = {k: hashlib.sha256(v).digest() for k, v in objs.items()}
    set_of = {k: crc_hash_mod(k, 2) for k in objs}
    if set(set_of.values()) != {0, 1}:
        fail(f"boot phase: the objects do not cover both sets: {set_of}")
    out: dict = {"drives": BOOT_DRIVES, "sets": 2, "objects": len(objs)}
    servers: list = []

    def admin(signer, method, tail, query=None, want=200):
        st, _h, body = signer.request(method, f"{ADMIN}/{tail}", query)
        if st != want:
            fail(f"boot phase: admin {method} {tail}: {st} {body[:300]!r}")
        return _json.loads(body) if body else {}

    def stats(signer) -> dict:
        return admin(signer, "GET", "kernel-stats")

    def step_delta(a: dict, b: dict) -> dict:
        pa, pb = a["device_passes"], b["device_passes"]
        return {
            "device_passes": {k: pb[k] - pa.get(k, 0) for k in pb
                              if pb[k] != pa.get(k, 0)},
            "flushes": b["batch"]["flushes"] - a["batch"]["flushes"],
            "jobs": b["batch"]["jobs"] - a["batch"]["jobs"],
            "multi_client_flushes": (b["batch"]["multi_client_flushes"]
                                     - a["batch"]["multi_client_flushes"]),
            "wait_seconds": b["batch"]["wait_seconds"]
            - a["batch"]["wait_seconds"],
        }

    def boot(tag: str) -> "tuple[_BootedServer, float]":
        srv = _BootedServer(work, _free_port(), env, tag)
        servers.append(srv)
        return srv, srv.wait_ready()

    def wait_files(root: str, want: dict, t0: float, what: str) -> float:
        """Seconds from ``t0`` until ``root`` holds exactly ``want``."""
        while time.monotonic() - t0 < BOOT_HEAL_S:
            if _drive_files(root, "boot") == want:
                return time.monotonic() - t0
            time.sleep(0.1)
        got = _drive_files(root, "boot")
        fail(f"boot phase: {what}: {len(got)} of {len(want)} files back, "
             f"{sum(got.get(k) == v for k, v in want.items())} equal")

    def get_all(host, port) -> "tuple[float, int]":
        def get(signer, key):
            st, _h, body = signer.request("GET", f"/boot/{key}")
            if st != 200 or hashlib.sha256(body).digest() != sha[key]:
                fail(f"boot phase: GET {key}: {st}, body differs from its source")
            return len(body)

        keys = sorted(objs)
        wall, sizes = _in_clients(host, port,
                                  [keys[c::S3_CLIENTS] for c in range(S3_CLIENTS)],
                                  get)
        return wall, sum(sizes)

    t_phase = time.monotonic()
    try:
        os.makedirs(os.path.join(work, "boot"), exist_ok=True)
        # -- 1. boot -------------------------------------------------------
        srv, out["ready_s"] = boot("first")
        host, port = "127.0.0.1", srv.port
        fmts = []
        for r in roots:
            with open(os.path.join(r, ".sys", "format.json")) as f:
                fmts.append(_json.load(f))
        dep = {f["id"] for f in fmts}
        layout = {(len(f["erasure"]["sets"]), len(f["erasure"]["sets"][0]))
                  for f in fmts}
        if len(dep) != 1 or layout != {(2, per_set)}:
            fail(f"boot phase: format.json ids {dep}, layouts {layout}")
        for i, f in enumerate(fmts):
            if f["erasure"]["this"] != f["erasure"]["sets"][i // per_set][i % per_set]:
                fail(f"boot phase: drive {i + 1} is not in its slot")
        deployment = dep.pop()
        one = S3Signer(host, port)
        loops = admin(one, "GET", "loops/status")
        if loops["mode"] != "async" or not loops["count"]:
            fail(f"boot phase: loops/status {loops}")
        si = admin(one, "GET", "storageinfo")["zones"][0]
        if (si["disks"], si["online"]) != (BOOT_DRIVES, BOOT_DRIVES):
            fail(f"boot phase: storageinfo {si}")
        out["loops"] = loops["count"]
        out["reuseport"] = loops["reuseport"]
        st, _h, body = one.request("PUT", "/boot")
        if st != 200:
            fail(f"boot phase: bucket create {st} {body[:200]!r}")

        # -- 2. traffic: 4 clients PUT 8 x 64 MiB + the 10 MiB + 17 B at once
        def put(signer, key):
            st, _h, body = signer.request("PUT", f"/boot/{key}", body=objs[key],
                                          payload_hash=sha[key].hex())
            if st != 200:
                fail(f"boot phase: PUT {key}: {st} {body[:200]!r}")
            return len(objs[key])

        keys = sorted(objs)
        s0 = stats(one)
        put_wall, put_sizes = _in_clients(
            host, port, [keys[c::S3_CLIENTS] for c in range(S3_CLIENTS)], put)
        s1 = stats(one)
        # a write that missed drives queued its object for MRF heal: let
        # the heal routine finish, then every drive of the object's set
        # must hold it
        t0 = time.monotonic()
        while admin(one, "GET", "background-heal/status")["nodes"][0]["queued"]:
            if time.monotonic() - t0 > BOOT_HEAL_S:
                fail("boot phase: the MRF queue did not drain")
            time.sleep(0.1)
        short = {}
        for k, s in set_of.items():
            lacking = [d for d in range(s * per_set, (s + 1) * per_set)
                       if not os.path.exists(os.path.join(roots[d], "boot", k,
                                                          "xl.meta"))]
            if lacking:
                short[k] = lacking
                admin(one, "POST", "heal", {"bucket": "boot", "object": k})
        held = {s: sum(1 for d in range(s * per_set, (s + 1) * per_set)
                       for k in objs if os.path.exists(
                           os.path.join(roots[d], "boot", k, "xl.meta")))
                for s in (0, 1)}
        want_held = {s: per_set * sum(1 for v in set_of.values() if v == s)
                     for s in (0, 1)}
        if held != want_held:
            fail(f"boot phase: shards by set {held}, want {want_held}")
        get_wall, get_bytes = get_all(host, port)
        s2 = stats(one)

        # -- 3. a drive of set 0 replaced while the server runs ------------
        live = roots[BOOT_WIPE_LIVE - 1]
        before_live = _drive_files(live, "boot")
        set0 = sorted(k for k, s in set_of.items() if s == 0)
        if {p.split("/xl.meta")[0] for p in before_live if p.endswith("xl.meta")} != set(set0):
            fail("boot phase: drive 5 does not hold every set-0 object")
        t0 = time.monotonic()
        _wipe_drive(live)
        live_heal_s = wait_files(live, before_live, t0,
                                 f"drive {BOOT_WIPE_LIVE} healed back")
        with open(os.path.join(live, ".sys", "format.json")) as f:
            doc = _json.load(f)
        if (doc["id"], doc["erasure"]["this"]) != (
                deployment, fmts[BOOT_WIPE_LIVE - 1]["erasure"]["this"]):
            fail("boot phase: the wiped drive was stamped with another identity")
        s3 = stats(one)

        # -- 4. admin heal of one deleted shard file of a set-1 object -----
        victim = sorted(k for k, s in set_of.items() if s == 1)[0]
        vroot = roots[per_set + 3]
        vfiles = {p: h for p, h in _drive_files(vroot, "boot").items()
                  if p.startswith(victim + "/") and "part." in p}
        if not vfiles:
            fail(f"boot phase: drive {per_set + 4} lacks {victim}'s part file")
        vpath = sorted(vfiles)[0]
        os.remove(os.path.join(vroot, "boot", vpath))
        t0 = time.monotonic()
        res = admin(one, "POST", "heal", {"bucket": "boot", "object": victim})
        admin_heal_s = time.monotonic() - t0
        if _drive_files(vroot, "boot").get(vpath) != vfiles[vpath]:
            fail(f"boot phase: admin heal of {victim} left {vpath} {res}")
        s4 = stats(one)
        one.close()

        # -- 5. SIGTERM ------------------------------------------------------
        out["sigterm_s"] = [srv.sigterm()]
        first_out = srv.output()

        # -- 6. a drive of set 1 replaced while the server is down ---------
        down = roots[BOOT_WIPE_DOWN - 1]
        before_down = _drive_files(down, "boot")
        _wipe_drive(down)
        srv, ready2 = boot("restart")
        t_ready = time.monotonic()
        port = srv.port
        with open(os.path.join(down, ".sys", "format.json")) as f:
            doc = _json.load(f)
        if (doc["id"], doc["erasure"]["this"]) != (
                deployment, fmts[BOOT_WIPE_DOWN - 1]["erasure"]["this"]):
            fail("boot phase: the restart did not stamp drive 17 into its slot")
        one = S3Signer(host, port)
        r0 = stats(one)
        down_heal_s = wait_files(down, before_down, t_ready,
                                 f"drive {BOOT_WIPE_DOWN} healed back")
        r1 = stats(one)
        get2_wall, _ = get_all(host, port)
        r2 = stats(one)

        # -- 7. one S3 Select (Q1) on the restarted server -----------------
        sel_data = lineitem_csv(SEED + 16, SELECT_ROW_OBJECT)
        for method, path, body in (("PUT", "/bootsel", b""),
                                   ("PUT", "/bootsel/lineitem.csv", sel_data)):
            st, _h, got = one.request(method, path, body=body)
            if st != 200:
                fail(f"boot phase: {method} {path}: {st} {got[:200]!r}")
        t0 = time.monotonic()
        st, _h, got = one.request("POST", "/bootsel/lineitem.csv",
                                  {"select": "", "select-type": "2"},
                                  select_body(SELECT_QUERIES["Q1"]))
        sel_s = time.monotonic() - t0
        if st != 200:
            fail(f"boot phase: select Q1: {st} {got[:300]!r}")
        recs = select_records(got)[0]
        from minio_tpu_torch.s3select.engine import run_select

        frames: list = []
        os.environ["MINIO_TPU_SELECT"] = "host"
        try:
            run_select(select_body(SELECT_QUERIES["Q1"]), sel_data, frames.append,
                       device="cpu")
        finally:
            os.environ.pop("MINIO_TPU_SELECT", None)
        if not recs or recs != select_records(b"".join(frames))[0]:
            fail("boot phase: select Q1 differs from the host engine's answer")
        prom = _prom_select(one)
        if prom.get('miniotpu_select_requests_total{engine="device"}', 0) < 1:
            fail(f"boot phase: select Q1 ran on no device engine: {prom}")
        out["select_Q1"] = {"bytes": len(sel_data), "records_bytes": len(recs),
                            "s": sel_s, "prometheus": prom}
        one.close()
        out["sigterm_s"].append(srv.sigterm())
        restart_out = srv.output()
    finally:
        for s in servers:
            s.kill()
    for name, text in (("first", first_out), ("restart", restart_out)):
        lines = text.splitlines()
        if not any("(bootstrapping)" in ln for ln in lines) or not any(
                ln.startswith("minio-tpu serving 1 zone(s) [24] drives") for ln in lines):
            fail(f"boot phase: the {name} boot's lines: {lines[:6]}")
    nput = sum(put_sizes)
    out.update({
        "phase_s": time.monotonic() - t_phase,
        "ready_s": [out["ready_s"], ready2],
        "deployment_kept": True,
        "put_concurrent": {"bytes": nput, "s": put_wall,
                           "MBps": nput / put_wall / 1e6},
        "get_concurrent": {"bytes": get_bytes, "s": get_wall,
                           "MBps": get_bytes / get_wall / 1e6},
        "get_after_restart": {"bytes": get_bytes, "s": get2_wall,
                              "MBps": get_bytes / get2_wall / 1e6},
        "heal_live": {"drive": BOOT_WIPE_LIVE, "files": len(before_live),
                      "objects": len(set0), "s": live_heal_s},
        "heal_down": {"drive": BOOT_WIPE_DOWN, "files": len(before_down),
                      "s_after_ready": down_heal_s},
        "admin_heal": {"object": victim, "file": vpath, "s": admin_heal_s,
                       "healed": res.get("healed")},
        "short_writes": short,
        "steps": {
            "put": step_delta(s0, s1), "get": step_delta(s1, s2),
            "heal_live": step_delta(s2, s3), "admin_heal": step_delta(s3, s4),
            "heal_down": step_delta(r0, r1), "get_after_restart": step_delta(r1, r2),
        },
    })
    return out


# ---------------------------------------------------------------------------
# slice 6: S3 Select (K8-K11 and the select sub-phase)
# ---------------------------------------------------------------------------

# TPC-H lineitem (TPC-H specification 4.2.3): 16 fields, "|" delimiter,
# a header row, no trailing delimiter, rows in l_orderkey order as dbgen
# writes them (sparse keys 1-7, 32-39, ...; 1-7 lines an order).  Text
# fields hold words only, as TPC-H's text grammar does: no quote and no
# digit, so no chunk is a hazard under a numeric compare's sci guard.
_LI_WORDS = (
    "furiously carefully quickly slyly blithely fluffily ironic regular "
    "express final pending special even bold silent unusual idle close "
    "ruthless permanent daring busy deposits packages accounts requests "
    "instructions theodolites pinto beans foxes ideas dependencies excuses "
    "platelets asymptotes courts dolphins multipliers sauternes warhorses "
    "frets dinos attainments somas tithes sheaves decoys across above "
    "against along among around after at before behind beneath beside "
    "besides between beyond by during inside into near of on outside over "
    "past since through throughout to toward under until up upon via with "
    "within without haggle nag wake sleep detect integrate cajole use "
    "boost affix engage grow sublate are").split()
_LI_INSTRUCT = ("DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN")
_LI_MODES = ("REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB")
LI_HEADER = (
    "l_orderkey|l_partkey|l_suppkey|l_linenumber|l_quantity|"
    "l_extendedprice|l_discount|l_tax|l_returnflag|l_linestatus|"
    "l_shipdate|l_commitdate|l_receiptdate|l_shipinstruct|l_shipmode|"
    "l_comment")
SELECT_OBJECT = 256 << 20  # 8 DEV_CHUNKs, about 2.1 M rows
SELECT_ROW_OBJECT = 16 << 20  # the `row` engine's comparison object
# Q1 row-anchored and selective (K8, K9, K10 [row]); Q2 field-anchored,
# about 1/7 of rows (K10 [back]); Q3 a numeric compare the screen cannot
# discriminate (13-14 candidates a row: past _MAX_CANDS in a 32 MiB
# chunk, so `overflow` on every chunk); Q4 a string compare half the rows
# match (`ratio` on every chunk)
SELECT_QUERIES = {
    "Q1": "SELECT * FROM S3Object s WHERE s.l_orderkey < 1000",
    "Q2": ("SELECT s.l_orderkey, s.l_extendedprice FROM S3Object s "
           "WHERE s.l_shipmode = 'AIR'"),
    "Q3": "SELECT s.l_orderkey FROM S3Object s WHERE s.l_quantity < 24",
    "Q4": "SELECT s.l_orderkey FROM S3Object s WHERE s.l_linestatus = 'O'",
}
SELECT_FALLBACK = {"Q1": None, "Q2": None, "Q3": "overflow", "Q4": "ratio"}


@functools.lru_cache(maxsize=2)
def lineitem_csv(seed: int, nbytes: int) -> bytes:
    """About ``nbytes`` (whole rows, at most nbytes) of lineitem rows from
    ``seed``: keys, part, supplier and line numbers per row; the other
    twelve fields of each row drawn from 65,536 rows made from the seed.
    The last two objects are kept: the read-cache phase scans the select
    phase's object again, and making it takes seconds."""
    import numpy as np

    rng = np.random.default_rng(seed)
    base = np.datetime64("1992-01-02")
    cutoff = int((np.datetime64("1995-06-17") - base).astype(int))
    T = 1 << 16
    qty = rng.integers(1, 51, T)
    price = (90000 + rng.integers(0, 20001, T)) * qty  # cents
    disc = rng.integers(0, 11, T)
    tax = rng.integers(0, 9, T)
    ship = rng.integers(1, 2526, T)
    commit = ship + rng.integers(-60, 61, T)
    receipt = ship + rng.integers(1, 31, T)
    rflag = np.where(receipt <= cutoff,
                     np.where(rng.integers(0, 2, T) == 1, "R", "A"), "N")
    lstat = np.where(ship > cutoff, "O", "F")

    def day(x):
        return np.datetime_as_string(base + x.astype("timedelta64[D]")).tolist()

    ins = np.array(_LI_INSTRUCT)[rng.integers(0, 4, T)]
    mode = np.array(_LI_MODES)[rng.integers(0, 7, T)]
    comments = []
    for _ in range(T):
        n = int(rng.integers(10, 44))
        words: list = []
        while sum(map(len, words)) + len(words) < n:
            words.append(_LI_WORDS[int(rng.integers(len(_LI_WORDS)))])
        comments.append(" ".join(words)[:n].rstrip())
    tails = [
        f"{q}|{g // 100}.{g % 100:02d}|0.{h:02d}|0.{t:02d}|{rf}|{ls}|{s1}|{s2}"
        f"|{s3}|{si}|{sm}|{cm}\n"
        for q, g, h, t, rf, ls, s1, s2, s3, si, sm, cm in zip(
            qty.tolist(), price.tolist(), disc.tolist(), tax.tolist(),
            rflag.tolist(), lstat.tolist(), day(ship), day(commit),
            day(receipt), ins.tolist(), mode.tolist(), comments)
    ]
    avg = sum(map(len, tails)) / T + 22
    R = int(nbytes / avg * 1.02) + 16
    lines = rng.integers(1, 8, R // 4 + 8)
    lines = lines[:int(np.searchsorted(np.cumsum(lines), R)) + 1]
    i = np.arange(1, len(lines) + 1)
    okey = np.repeat(((i >> 3) << 5) + (i & 7), lines)  # dbgen's mk_sparse
    lnum = np.arange(len(okey)) - np.repeat(np.cumsum(lines) - lines, lines) + 1
    part = rng.integers(1, 200001, len(okey))
    supp = rng.integers(1, 10001, len(okey))
    pick = rng.integers(0, T, len(okey)).tolist()
    body = "".join([LI_HEADER, "\n"] + [
        f"{a}|{b}|{c}|{e}|{tails[p]}" for a, b, c, e, p in zip(
            okey.tolist(), part.tolist(), supp.tolist(), lnum.tolist(), pick)
    ]).encode()
    return body[:body.rfind(b"\n", 0, nbytes) + 1]


def select_body(expr: str, fd: str = "|") -> bytes:
    """A SelectObjectContentRequest over CSV with a header row."""
    from xml.sax.saxutils import escape

    return (
        "<SelectObjectContentRequest>"
        f"<Expression>{escape(expr)}</Expression>"
        "<ExpressionType>SQL</ExpressionType><InputSerialization><CSV>"
        f"<FileHeaderInfo>USE</FileHeaderInfo><FieldDelimiter>{fd}"
        "</FieldDelimiter></CSV></InputSerialization>"
        f"<OutputSerialization><CSV><FieldDelimiter>{fd}</FieldDelimiter>"
        "</CSV></OutputSerialization></SelectObjectContentRequest>"
    ).encode()


def select_records(body: bytes) -> "tuple[bytes, list]":
    """(the Records payloads joined, the event types) of an EventStream
    response."""
    from minio_tpu_torch.s3select.message import decode_all

    msgs = decode_all(body)
    kinds = [m["headers"].get(":event-type") for m in msgs]
    if not kinds or kinds[-1] != "End" or "Stats" not in kinds:
        fail(f"select: the response's events are {kinds[-4:]}")
    return b"".join(m["payload"] for m, k in zip(msgs, kinds)
                    if k == "Records"), kinds


def screen_ops(atoms, anchor: str, sci_guard: bool) -> int:
    """Integer instructions per word of the screen: the JAX package's
    expression, each distinct shifted view W(k) and terminator / digit
    flag set counted once (memoized there too), every u64 operator (and,
    or, xor, not, add, sub, shift; a three-input and-not-and is one)
    two 32-bit instructions, a view W(k) with k % 8 != 0 two (two funnel
    shifts build its two halves), a popcount two; the block sums'
    shuffles and the scalars' reductions are left out."""
    seen: set = set()
    u64 = 0
    views = 0

    def view(k):
        nonlocal views
        if ("w", k) not in seen:
            seen.add(("w", k))
            views += 2 if k % 8 else 0

    def term(k):
        nonlocal u64
        if ("t", k) not in seen:
            seen.add(("t", k))
            view(k)
            u64 += 3 + 3 + 1  # two swar_eq, or

    def digit(k):
        nonlocal u64
        if ("d", k) not in seen:
            seen.add(("d", k))
            view(k)
            u64 += 3 + 3 + 1  # two swar_ge, and-not

    for branch in atoms:
        for atom in branch:
            kind = atom[0]
            if kind == "len":
                for ln in range(atom[1], atom[2] + 1):
                    term(ln + 1)
                    u64 += 1
            elif kind == "deep":
                for i in range(1, atom[1] + 1):
                    term(i)
                    u64 += 1
                u64 += 1
            elif kind == "byte0":
                view(1)
                u64 += 3 + 3 + 1 + (2 if atom[1] == 0 else 0)
            elif kind == "nd":
                for i in range(1, atom[1] + 1):
                    term(i)
                    digit(i)
                    u64 += 4
            else:
                lit, mode = atom[1], atom[2]
                n = min(len(lit), 8)
                for i in range(n):
                    view(i + 1)
                    if mode in ("lt", "le"):
                        term(i + 1)
                        u64 += 8
                    elif mode in ("gt", "ge"):
                        term(i + 1)
                        u64 += 7
                    u64 += 4  # pref &= swar_eq
                term(n + 1)
                u64 += 2
            u64 += 1  # the branch's and
        u64 += 1  # the or of branches
    view(0)
    u64 += 3  # newline flags
    if anchor == "field":
        term(0)
    view(1)
    u64 += 3 + 3 + 4 + 3 + 3  # base and, quote, bare CR, NUL, ors
    if sci_guard:
        digit(-1)
        u64 += 3 + 3 + 3
    return 2 * u64 + views + 2 * 2 + 4  # the two popcounts and the packing


def _positions_bytes(cum, cap: int) -> int:
    """Bytes extract_positions must read for ranks 0..cap-1: the 32-byte
    sectors of ``cum`` that the binary searches (searchsorted, side
    right) and the base reads touch, and the 64-byte candidate block of
    each rank, each counted once; the positions written out besides."""
    import numpy as np

    cum = cum.cpu().numpy()
    nblk = len(cum)
    k = np.arange(cap)
    lo, hi = np.zeros(cap, np.int64), np.full(cap, nblk, np.int64)
    read = []
    while (lo < hi).any():
        act = lo < hi
        mid = (lo + hi) >> 1
        read.append(mid[act])
        right = act & (cum[np.minimum(mid, nblk - 1)] <= k)
        lo = np.where(right, mid + 1, lo)
        hi = np.where(act & ~right, mid, hi)
    b = np.minimum(lo, nblk - 1)
    read.append(b[b > 0] - 1)
    sectors = len(np.unique(np.concatenate(read) // 8))
    return 32 * sectors + 64 * len(np.unique(b)) + 4 * cap


def _span_scanned(arr, anchors, window: int, back: bool) -> int:
    """Bytes the span function must look at for these anchors: up to and
    including the newline it finds, the whole window where none."""
    from minio_tpu_torch.ops import select_step as ss

    fn = ss.anchors_back_plain if back else ss.row_spans_plain
    off, found = fn(arr, anchors, window=window)
    if back:
        off = anchors.long() - off.long()
    n = (off.long() + 1).clamp(max=window)
    return int(n.masked_fill(~found, window).sum().item())


def select_programs(rng) -> dict:
    """The screens check_select_kernels holds K8 to, by label: Q1-Q4, an
    IN list of 16 options field and row anchored, one of 150 (more records
    than a launch passes by value), every atom kind under both anchors
    (sci guard off and on), and one program for each lookahead of 1-6
    words."""
    from minio_tpu_torch.s3select import device as sdev, sql

    header = LI_HEADER.split("|")

    def screen(where: str):
        return sdev.compile_screen(sql.parse(
            f"SELECT * FROM S3Object s WHERE {where}").where, header)

    progs = {q: sdev.compile_screen(sql.parse(t).where, header)
             for q, t in SELECT_QUERIES.items()}
    keys = ", ".join(str(int(k)) for k in rng.integers(1, 200000, 16))
    progs["IN16 field"] = screen(f"s.l_partkey IN ({keys})")
    progs["IN16 row"] = screen(f"s.l_orderkey IN ({keys})")
    many = ", ".join(str(int(k)) for k in rng.integers(1, 200000, 150))
    progs["IN150 field"] = screen(f"s.l_partkey IN ({many})")
    kinds = ((("len", 1, 3), ("byte0", 48, 57)), (("deep", 5), ("nd", 7)),
             (("lex", b"1000", "lt"),), (("lex", b"TAKE BACK RETURN", "le"),),
             (("lex", b"MAIL", "eq"),), (("lex", b"1997-09", "ge"),),
             (("lex", b"SHIP", "gt"),), (("byte0", 0, 50), ("len", 0, 0)))
    progs["kinds row"] = sdev._Screen(kinds, "row", False)
    progs["kinds field sci"] = sdev._Screen(kinds, "field", True)
    for q in range(1, 7):  # q words read offsets up to 8q - 1
        progs[f"lookahead {q}"] = sdev._Screen(
            ((("len", 0, 8 * q - 2),), (("nd", 8 * q - 1),),
             (("deep", 8 * q - 3), ("lex", b"12", "ge"))), "field", q % 2 == 0)
    return progs


def check_select_kernels(dev, rng) -> dict:
    """K8-K11 against their plain versions on the card, at the select
    path's shapes: a 32 MiB lineitem chunk (one DEV_CHUNK) under the
    programs of ``select_programs``; a hazard chunk (a quote, a bare CR);
    the SWAR-borrow planes (within a word's half, and from lane 3 into
    lane 4); positions of every program's candidates; row spans at the
    three windows and backward anchors over the lineitem chunk and over a
    plane of rows 10-6,000 bytes wide (found and not found, the chunk
    start); gathers at 4-4,096-byte windows, at every start alignment and
    plane offset, clamped at both ends of the plane.  Times each at the
    path's shape beside its bound and its plain version (K8 under Q1, Q2
    and the IN list's field screen; K11 also at one row, the launch's
    fixed chain); K9 and K11 also beside the PyTorch calls that compute
    the same function (K9: ``torch.nonzero`` of the candidate bytes)."""
    import numpy as np
    import torch

    from minio_tpu_torch.ops import select_step as ss
    from minio_tpu_torch.s3select import device as sdev, sql

    fd, qc = ord("|"), ord('"')
    data = lineitem_csv(SEED + 14, sdev.DEV_CHUNK)
    header = LI_HEADER.split("|")
    plane = sdev.host_plane(data, dev)
    nbytes = plane.numel()
    progs = select_programs(rng)
    if {ss.screen_program(p.atoms).q for p in progs.values()} != set(range(1, 7)):
        fail("select kernels: the programs miss a lookahead of 1-6 words")
    if ss.screen_program(progs["IN150 field"].atoms).nrec <= ss._PARAM_RECS:
        fail("select kernels: the IN150 program fits the launch's parameters")
    for kind in ("len", "deep", "byte0", "nd", "lex"):
        if not any(a[0] == kind for p in progs.values() for b in p.atoms
                   for a in b):
            fail(f"select kernels: no program holds a {kind} atom")
    if len(progs["IN16 field"].atoms) < 16:
        fail("select kernels: the IN program has fewer than 16 branches")
    # a hazard chunk: a quote in one row, a bare CR in another
    hz = bytearray(data[:4 << 20])
    hz[1000] = qc
    hz[2_000_001] = 13
    hazard = sdev.host_plane(bytes(hz), dev)
    borrow = sdev.host_plane(b"a,b\n1,-5\n22,7\n", dev)
    # a ``,`` at byte 3 of a word, ``-`` (``,`` ^ 1) at byte 4: the borrow
    # from lane 3 into lane 4, across the word's 32-bit halves
    borrow34 = sdev.host_plane(b"xyz,-a,b\n,-1,22\n" * 8, dev)

    def screen(arr, scr, fdb=fd, fn=ss.screen_chunk):
        return fn(arr, fd=fdb, qc=qc, atoms=scr.atoms, anchor=scr.anchor,
                  sci_guard=scr.sci_guard)

    def screen_plain(arr, scr, fdb=fd):
        return screen(arr, scr, fdb, ss.screen_chunk_plain)

    err = 0
    counts = {}
    outs = {}
    for label, scr in progs.items():
        got = screen(plane, scr)
        want = screen_plain(plane, scr)
        e = same(got, want)
        if e:
            fail(f"select_screen differs from its plain version under {label}")
        err = max(err, e)
        outs[label] = got
        counts[label] = {"rows": int(got[2].item()), "cands": int(got[1].sum().item()),
                         "hazard": bool(got[3].item())}
        if counts[label]["hazard"]:
            fail(f"select_screen: the lineitem chunk is a hazard under {label}")
        for hlabel, arr in (("hazard", hazard),):
            g, w = screen(arr, scr), screen_plain(arr, scr)
            if same(g, w) or not bool(g[3].item()):
                fail(f"select_screen on the hazard chunk under {label}: "
                     f"hazard {bool(g[3].item())}")
    bscr = sdev._Screen(((("deep", 2),),), "field", False)
    g = screen(borrow, bscr, ord(","))
    if same(g, screen_plain(borrow, bscr, ord(","))):
        fail("select_screen differs from its plain version on the borrow plane")
    flags = np.unpackbits(g[0].cpu().numpy().view(np.uint8), bitorder="little")
    if (np.flatnonzero(flags) // 8).tolist() != [8, 13]:
        fail(f"select_screen: borrow plane flags {np.flatnonzero(flags) // 8}")
    g = screen(borrow34, bscr, ord(","))
    if same(g, screen_plain(borrow34, bscr, ord(","))):
        fail("select_screen differs from its plain version across a word's halves")
    flags = np.flatnonzero(np.unpackbits(g[0].cpu().numpy().view(np.uint8),
                                         bitorder="little")) // 8
    if 3 in flags.tolist() or 16 + 3 in flags.tolist():
        fail(f"select_screen: the lane 3 -> 4 borrow lost, flags {flags[:8]}")
    # the reference's own numbers on the chunk: Q1 flags keys of up to 4
    # digits, Q2 the AIR rows, Q3 past _MAX_CANDS, Q4 past the ratio cap
    nrows = data.count(b"\n")
    if counts["Q1"]["rows"] != nrows:
        fail(f"select_screen: {counts['Q1']['rows']} rows, the chunk has {nrows}")
    if counts["Q3"]["cands"] <= sdev._MAX_CANDS or not (
            nrows * sdev._RATIO_CAP < counts["Q4"]["cands"] <= sdev._MAX_CANDS):
        fail(f"select_screen: Q3/Q4 candidate counts {counts}")
    res: dict = {}

    # K8 timed under Q1 (the selective row screen) and Q2
    def k8_row(label):
        scr = progs[label]
        nw = nbytes // 8
        bms, by = bound(2 * nbytes + nbytes // 16,
                        nw * screen_ops(scr.atoms, scr.anchor, scr.sci_guard))
        return dict(
            ms=cuda_ms(lambda: screen(plane, scr), 20),
            plain_ms=cuda_ms(lambda: screen_plain(plane, scr), 3, 1),
            bound_ms=bms, bound_by=by, shape=[nbytes], program=label,
            records=ss.screen_program(scr.atoms).nrec, lookahead=ss.screen_program(scr.atoms).q,
            int_ops_per_word=screen_ops(scr.atoms, scr.anchor, scr.sci_guard),
            **device_times(lambda: screen(plane, scr)))

    res["select_screen"] = dict(max_abs_err=err, **k8_row("Q1"))
    res["select_screen"]["Q2"] = k8_row("Q2")
    res["select_screen"]["IN16 field"] = k8_row("IN16 field")

    # --- K9 positions -------------------------------------------------------
    err = 0
    pos = {}
    for label, (cand, blk, _n, _h) in outs.items():
        count = counts[label]["cands"]
        if not count or count > sdev._MAX_CANDS:
            continue
        cum = torch.cumsum(blk, 0, dtype=torch.int32)
        cap = 1 << max(6, (count - 1).bit_length())
        # the whole output: the ranks past the count go on to K10 [back]
        got = ss.extract_positions(cand, cum, cap=cap)
        want = ss.extract_positions_plain(cand, cum, cap=cap)
        e = same((got,), (want,))
        if e:
            fail(f"select_positions differs from its plain version under {label}")
        err = max(err, e)
        pos[label] = got[:count]
    if "Q1" not in pos or "Q2" not in pos:
        fail("select_positions: Q1 or Q2 has no candidates")
    cand, blk = outs["Q1"][0], outs["Q1"][1]
    cum = torch.cumsum(blk, 0, dtype=torch.int32)
    count = counts["Q1"]["cands"]
    cap = 1 << max(6, (count - 1).bit_length())
    nblk = cum.numel()
    steps = max(1, nblk.bit_length())
    bms, by = bound(_positions_bytes(cum, cap), cap * (4 * steps + 8 * 6 + 6 * 11))

    # the one PyTorch call that computes the same positions: every
    # candidate byte is 0x80 (_HI's lanes), so its nonzero bytes are the
    # positions in rank order (the call syncs: it sizes its output)
    def nonzero():
        return torch.nonzero(cand.view(torch.uint8)).flatten()[:count]

    flagged = cand.view(torch.uint8)
    if not bool(((flagged == 0) | (flagged == 0x80)).all().item()):
        fail("select_positions: a candidate byte other than 0x80")
    if not torch.equal(nonzero().to(torch.int32), pos["Q1"]):
        fail("select_positions: torch.nonzero's positions differ from K9's")
    res["select_positions"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: ss.extract_positions(cand, cum, cap=cap), 20),
        plain_ms=cuda_ms(lambda: ss.extract_positions_plain(cand, cum, cap=cap), 3, 1),
        library_ms=cuda_ms(nonzero, 20),
        bound_ms=bms, bound_by=by, shape=[cap, nblk], program="Q1",
        **device_times(lambda: ss.extract_positions(cand, cum, cap=cap)))

    # --- K10 spans ------------------------------------------------------------
    wide_rows = []
    for n in rng.integers(10, 6000, 1500):
        wide_rows.append(b"w" * int(n) + b"\n")
    wide = sdev.host_plane(b"".join(wide_rows), dev)
    nl = torch.nonzero(plane[:len(data)] == 10).flatten().to(torch.int32)
    wnl = torch.nonzero(wide == 10).flatten().to(torch.int32)
    mids = torch.from_numpy(rng.integers(0, wide.numel(), 4096).astype(np.int32)).to(dev)
    err_row = err_back = 0
    for window in (256, 1024, 4096):
        for label, arr, anchors in (
                ("Q1", plane, torch.cat([torch.tensor([-1], dtype=torch.int32, device=dev),
                                         pos["Q1"]])),
                ("every row", plane, torch.cat([torch.tensor([-1], dtype=torch.int32,
                                                             device=dev), nl])),
                ("wide rows", wide, torch.cat([torch.tensor([-1], dtype=torch.int32,
                                                            device=dev), wnl])),
                ("wide mid-row", wide, mids)):
            e = same(ss.row_spans(arr, anchors, window=window),
                     ss.row_spans_plain(arr, anchors, window=window))
            if e:
                fail(f"select_spans[row] differs from its plain version: {label}, "
                     f"window {window}")
            err_row = max(err_row, e)
    for label, arr, hits in (("Q2", plane, pos["Q2"]), ("wide mid-row", wide, mids),
                             ("chunk start", plane,
                              torch.arange(0, 2048, 7, dtype=torch.int32, device=dev))):
        for window in (1024, 256):
            got = ss.anchors_back(arr, hits, window=window)
            e = same(got, ss.anchors_back_plain(arr, hits, window=window))
            if e:
                fail(f"select_spans[back] differs from its plain version: {label}")
            err_back = max(err_back, e)
    wf = ss.row_spans(wide, torch.cat([torch.tensor([-1], dtype=torch.int32, device=dev),
                                       wnl]), window=256)[1]
    if bool(wf.all().item()) or not bool(wf.any().item()):
        fail("select_spans[row]: the wide plane found every row or none at 256")
    q1a = torch.cat([torch.tensor([-1], dtype=torch.int32, device=dev), pos["Q1"]])
    C = q1a.numel()
    bms, by = bound(9 * C + _span_scanned(plane, q1a, 256, False),
                    2 * _span_scanned(plane, q1a, 256, False))
    res["select_spans[row]"] = dict(
        max_abs_err=err_row, ms=cuda_ms(lambda: ss.row_spans(plane, q1a, window=256), 20),
        plain_ms=cuda_ms(lambda: ss.row_spans_plain(plane, q1a, window=256), 3, 1),
        bound_ms=bms, bound_by=by, shape=[C, 256], program="Q1",
        **device_times(lambda: ss.row_spans(plane, q1a, window=256)))
    q2h = pos["Q2"]
    C = q2h.numel()
    scanned = _span_scanned(plane, q2h, sdev._BACK_WINDOW, True)
    bms, by = bound(9 * C + scanned, 2 * scanned)
    res["select_spans[back]"] = dict(
        max_abs_err=err_back,
        ms=cuda_ms(lambda: ss.anchors_back(plane, q2h, window=sdev._BACK_WINDOW), 20),
        plain_ms=cuda_ms(lambda: ss.anchors_back_plain(plane, q2h,
                                                       window=sdev._BACK_WINDOW), 3, 1),
        bound_ms=bms, bound_by=by, shape=[C, sdev._BACK_WINDOW], program="Q2",
        **device_times(lambda: ss.anchors_back(plane, q2h, window=sdev._BACK_WINDOW)))

    # --- K11 gather -------------------------------------------------------------
    err = 0
    ends = torch.from_numpy(np.concatenate([
        rng.integers(nbytes - 300, nbytes, 64), rng.integers(-300, 0, 16),
        [0, -1, nbytes - 1, nbytes]]).astype(np.int32)).to(dev)
    cases = [(256, plane, q1a + 1), (64, plane, ends), (4096, wide, mids[:512]),
             (64, plane, torch.zeros(0, dtype=torch.int32, device=dev))]
    # every start alignment and plane offset, windows off the 16-byte chunk
    for off in (1, 3, 8, 13):
        for window in (4, 12, 36, 64, 256):
            cases.append((window, plane[off:], torch.cat([ends, q1a[:512] + 1])))
    for window, arr, starts in cases:
        e = same((ss.gather_rows(arr, starts, window=window),),
                 (ss.gather_rows_plain(arr, starts, window=window),))
        if e:
            fail(f"select_gather differs from its plain version at window {window}")
        err = max(err, e)
    starts = q1a + 1
    C = starts.numel()
    idx = (starts.long()[:, None] + torch.arange(256, device=dev)[None, :]).clamp(
        0, nbytes - 1)
    bms, by = bound(4 * C + 2 * C * 256, 3 * C * 256)
    res["select_gather"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: ss.gather_rows(plane, starts, window=256), 20),
        plain_ms=cuda_ms(lambda: ss.gather_rows_plain(plane, starts, window=256), 3, 1),
        library_ms=cuda_ms(lambda: plane[idx], 20),
        bound_ms=bms, bound_by=by, shape=[C, 256], program="Q1",
        **device_times(lambda: ss.gather_rows(plane, starts, window=256)))
    one = starts[:1].clone()
    res["select_gather"]["one_row"] = dict(
        ms=cuda_ms(lambda: ss.gather_rows(plane, one, window=256), 20),
        **device_times(lambda: ss.gather_rows(plane, one, window=256)))
    res["select_screen"]["counts"] = counts
    torch.cuda.synchronize()
    return res


def _prom_select(signer) -> dict:
    """The miniotpu_select_* samples of the server's Prometheus page."""
    st, _h, body = signer.request("GET", "/minio-tpu/prometheus/metrics")
    if st != 200:
        fail(f"select: Prometheus answered {st}")
    out = {}
    for line in body.decode().splitlines():
        if line.startswith("miniotpu_select_"):
            name, _sp, value = line.rpartition(" ")
            out[name] = float(value)
    return out


def select_phase(dev, work: str) -> dict:
    """Phase 9 (slice 6): S3 Select pushdown on the port's S3Server
    (threaded plane) over a fresh ErasureObjects on the card (12 disks,
    EC 8+4, 10 MiB blocks).  A 256 MiB TPC-H lineitem CSV (about 2.1 M
    rows, 8 DEV_CHUNKs) PUT with SigV4, then Q1-Q4 through POST
    ?select&select-type=2 under the default engine (auto: the device
    screen) and under MINIO_TPU_SELECT=host, whose Records must be byte
    identical; Q1 on a 16 MiB object of the same shape against the
    ``row`` engine; Q1 with the disks of shards 1, 3, 10 and 12 offline;
    Q1 and Q2 from 4 clients at once; the Select families in Prometheus;
    ``DeviceScan.run_device`` over ``as_device_plane`` of the object's
    10 MiB blocks on the card.  K8-K11 must launch, the fallbacks match
    SELECT_FALLBACK, and the counters move."""
    import torch

    from minio_tpu_torch.codec.telemetry import KERNEL_STATS
    from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
    from minio_tpu_torch.ops import kernels, select_step as ss
    from minio_tpu_torch.s3select import device as sdev
    from minio_tpu_torch.s3select.engine import S3Select, SelectRequest
    from minio_tpu_torch.server.http import S3Server
    from minio_tpu_torch.storage.xl import XLStorage

    roots = [os.path.join(work, f"seldisk{i}") for i in range(N)]
    ol = ErasureObjects([XLStorage(r) for r in roots], parity_blocks=M,
                        block_size=BLOCK)
    srv = S3Server(ol, address="127.0.0.1:0").start()
    if srv.server_mode != "threaded":
        fail(f"select: server plane {srv.server_mode}")
    host, port = srv.host, srv.port
    t0 = time.monotonic()
    big = lineitem_csv(SEED + 6, SELECT_OBJECT)
    small = lineitem_csv(SEED + 16, SELECT_ROW_OBJECT)
    out: dict = {"object_bytes": len(big), "rows": big.count(b"\n") - 1,
                 "row_object_bytes": len(small), "make_s": time.monotonic() - t0}
    one = S3Signer(host, port)
    os.environ.pop("MINIO_TPU_SELECT", None)
    try:
        st, _h, body = one.request("PUT", "/sel")
        if st != 200:
            fail(f"select: bucket create {st} {body[:200]!r}")
        for key, data in (("lineitem.csv", big), ("lineitem16.csv", small)):
            t0 = time.monotonic()
            st, _h, body = one.request("PUT", f"/sel/{key}", body=data)
            if st != 200:
                fail(f"select: PUT {key}: {st} {body[:200]!r}")
            out.setdefault("put_s", {})[key] = time.monotonic() - t0
        kernels.reset_launches()
        KERNEL_STATS.reset()
        sdev.STATS.reset()
        t_phase = time.monotonic()

        def post(signer, key, q, mode=None):
            """(records, seconds, STATS delta) of one request."""
            if mode:
                os.environ["MINIO_TPU_SELECT"] = mode
            try:
                s0 = sdev.STATS.snapshot()
                t = time.monotonic()
                st, _h, body = signer.request(
                    "POST", f"/sel/{key}", {"select": "", "select-type": "2"},
                    select_body(SELECT_QUERIES[q]))
                took = time.monotonic() - t
                s1 = sdev.STATS.snapshot()
            finally:
                os.environ.pop("MINIO_TPU_SELECT", None)
            if st != 200:
                fail(f"select: {q} on {key} ({mode or 'auto'}): {st} {body[:300]!r}")
            recs, _kinds = select_records(body)
            delta = {
                "requests": {k: v - s0["requests"][k] for k, v in s1["requests"].items()
                             if v != s0["requests"][k]},
                "fallbacks": {k: v - s0["fallbacks"][k] for k, v in s1["fallbacks"].items()
                              if v != s0["fallbacks"][k]},
                "device_seconds": s1["device_seconds"] - s0["device_seconds"],
                "screened": {k: v - s0["screened"][k]
                             for k, v in s1["screened"].items()},
            }
            return recs, took, delta

        queries: dict = {}
        answers: dict = {}
        chunks = -(-len(big) // sdev.DEV_CHUNK)
        for q in SELECT_QUERIES:
            before = dict(kernels.LAUNCHES)
            recs, took, delta = post(one, "lineitem.csv", q)
            launched = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
                        if v != before[k]}
            hrecs, htook, hdelta = post(one, "lineitem.csv", q, "host")
            if recs != hrecs:
                fail(f"select: {q}'s device answer differs from the host engine's "
                     f"({len(recs)} and {len(hrecs)} bytes)")
            if not recs:
                fail(f"select: {q} answered no rows")
            want = SELECT_FALLBACK[q]
            want_fb = {want: chunks} if want else {}
            if (delta["requests"] != {"device": 1} or delta["fallbacks"] != want_fb
                    or delta["screened"]["chunks"] != chunks):
                fail(f"select: {q}'s engines, fallbacks and screened chunks {delta}, "
                     f"want {want_fb} and {chunks} chunks")
            if hdelta["requests"] != {"host": 1}:
                fail(f"select: {q} under host ran {hdelta}")
            answers[q] = recs
            queries[q] = {
                "records_bytes": len(recs), "rows": recs.count(b"\n"),
                "device": {"s": took, "MBps": len(big) / took / 1e6,
                           "device_seconds": delta["device_seconds"],
                           "screened": delta["screened"],
                           "fallbacks": delta["fallbacks"], "launches": launched},
                "host": {"s": htook, "MBps": len(big) / htook / 1e6},
            }
        for q, k in (("Q1", ("select_screen", "select_positions", "select_spans[row]")),
                     ("Q2", ("select_screen", "select_positions", "select_spans[back]",
                             "select_spans[row]"))):
            if any(not queries[q]["device"]["launches"].get(n) for n in k):
                fail(f"select: {q} launched {queries[q]['device']['launches']}")
        # Q1 against the row engine, on 16 MiB
        recs, took, _d = post(one, "lineitem16.csv", "Q1")
        rrecs, rtook, rdelta = post(one, "lineitem16.csv", "Q1", "row")
        if recs != rrecs or rdelta["requests"] != {"row": 1}:
            fail(f"select: Q1 on 16 MiB differs from the row engine ({rdelta})")
        out["row_check"] = {"bytes": len(small), "records_bytes": len(recs),
                            "device_s": took, "row_s": rtook,
                            "row_MBps": len(small) / rtook / 1e6}
        # Q1 with 4 disks offline: the GET reconstructs (K3)
        dist = XLStorage(roots[0]).read_version("sel", "lineitem.csv").erasure.distribution
        dead = sorted(d for d in range(N) if dist[d] in (1, 3, 10, 12))
        live = list(ol.disks)
        for d in dead:
            ol.disks[d] = None
        try:
            k3 = kernels.LAUNCHES["gf_matmul_words"]
            recs, took, _d = post(one, "lineitem.csv", "Q1")
            if kernels.LAUNCHES["gf_matmul_words"] <= k3 or recs != answers["Q1"]:
                fail("select: Q1 with 4 disks offline reconstructed nothing or differs")
        finally:
            ol.disks[:] = live
        out["degraded_Q1"] = {"s": took, "MBps": len(big) / took / 1e6,
                              "offline_disks": dead}
        # Q1 and Q2 from 4 clients at once
        jobs = [[("Q1",), ("Q2",)] for _ in range(S3_CLIENTS)]

        def job(signer, j):
            recs, took, _d = post(signer, "lineitem.csv", j[0])
            if recs != answers[j[0]]:
                fail(f"select: a concurrent {j[0]} differs from its single answer")
            return took

        wall, tooks = _in_clients(host, port, jobs, job)
        out["concurrent"] = {"clients": S3_CLIENTS, "requests": len(tooks),
                             "wall_s": wall,
                             "MBps": len(tooks) * len(big) / wall / 1e6,
                             "max_request_s": max(tooks)}
        # the Select families
        prom = _prom_select(one)
        snap = sdev.STATS.snapshot()
        want_dev = len(SELECT_QUERIES) + 1 + 1 + 2 * S3_CLIENTS
        if (prom.get('miniotpu_select_requests_total{engine="device"}') != want_dev
                or prom.get('miniotpu_select_fallback_total{reason="ratio"}')
                != chunks
                or prom.get("miniotpu_select_scanned_bytes_total", 0)
                < want_dev * len(big) // 2
                or prom.get("miniotpu_select_device_seconds_total", 0) <= 0):
            fail(f"select: Prometheus {prom}, want {want_dev} device requests")
        out["prometheus"] = prom
        # the device-resident plane: run_device over as_device_plane of the
        # object's 10 MiB blocks on the card (K11)
        buf = torch.frombuffer(bytearray(big), dtype=torch.uint8).to(dev)
        blocks = [buf[i:i + BLOCK] for i in range(0, len(big), BLOCK)]
        before = dict(kernels.LAUNCHES)
        t = time.monotonic()
        plane, nbytes = sdev.as_device_plane(blocks, len(big), dev)
        frames: list = []
        sel = S3Select(SelectRequest.from_xml(select_body(SELECT_QUERIES["Q1"])), dev)
        sel.evaluate(None, len(big), frames.append, device_source=(plane, nbytes))
        took = time.monotonic() - t
        recs, _k = select_records(b"".join(frames))
        launched = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
                    if v != before[k]}
        if recs != answers["Q1"] or not launched.get("select_gather"):
            fail(f"select: run_device over the resident plane: {len(recs)} bytes, "
                 f"launches {launched}")
        out["run_device_Q1"] = {"s": took, "MBps": len(big) / took / 1e6,
                                "launches": launched}
        del plane, buf, blocks
        out["phase_s"] = time.monotonic() - t_phase
        out["launches"] = dict(kernels.LAUNCHES)
        out["stats"] = sdev.STATS.snapshot()
        out["queries"] = queries
        out["batch"] = KERNEL_STATS.snapshot()["batch"]
        for name in (*ss.LAUNCH_NAMES, "phash256_batched", "gf_matmul_words"):
            if not out["launches"].get(name):
                fail(f"select: {name} never launched in the select sub-phase")
    finally:
        one.close()
        srv.shutdown()
    return out


# -- phase 9b: the tiered read cache (slice 9a) --------------------------------

RC_HOT = 8  # hot objects of S3_BIG each
RC_COLD = 16  # one-shot scan objects of S3_BIG each
RC_GETS = 4  # GETs of each hot object a pass (one a client)
# cut by the run's time, not by the card's 80 GB: a 1 GiB device tier,
# a 1 GiB host tier and a 2 GiB device budget for every plane
RC_ENV = {"MINIO_TPU_READ_CACHE_DEVICE_MB": "1024",
          "MINIO_TPU_READ_CACHE_MB": "1024",
          "MINIO_TPU_DEVICE_BUDGET_MB": "2048"}


def _disk_calls(disks) -> dict:
    """api -> calls summed over the metered disks."""
    out: dict = {}
    for d in disks:
        if d is None:
            continue
        for api, row in d.api_stats().items():
            out[api] = out.get(api, 0) + row["calls"]
    return out


def _moved(a: dict, b: dict) -> dict:
    return {k: v - a.get(k, 0) for k, v in b.items() if v != a.get(k, 0)}


class _Sink:
    """A GET's writer that counts the bytes and keeps none."""

    def __init__(self):
        self.n = 0

    def write(self, b):
        self.n += len(b)


def _ol_get_s(ol, key: str, reps: int = 3) -> list:
    """Seconds of each of ``reps`` object-layer GETs of ``key`` (no HTTP)."""
    out = []
    for _ in range(reps):
        sink = _Sink()
        t0 = time.monotonic()
        ol.get_object("bench", key, sink)
        out.append(time.monotonic() - t0)
        if sink.n != S3_BIG:
            fail(f"read_cache: an object-layer GET of {key} wrote {sink.n} bytes")
    return out


def hit_breakdown(c, be, key) -> dict:
    """Where one device-tier hit's time goes, piece by piece on one cached
    group: K2 over the resident rows (CUDA events), the verify with its
    digest readback, the D2H copy of the rows into fresh pageable memory,
    the copy-out of the blocks, and the whole ``lookup`` (host clock,
    synchronized); medians of 5."""
    import statistics

    import numpy as np
    import torch

    from minio_tpu_torch.cache import tiered
    from minio_tpu_torch.ops import codec_step

    ent = c._tiers["device"][key]
    t, dig = ent.data, ent.digests
    L = t.shape[-1]
    words = t.view(torch.int32)
    k2 = cuda_ms(lambda: codec_step.digest_words_batched(words, L), 10)

    def clock(fn) -> float:
        got = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            got.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(got)

    rows = tiered._to_host(t)
    block_len = BLOCK

    def copy_out():
        for gi in range(rows.shape[0]):
            np.ascontiguousarray(rows[gi, :, :block_len // K]).reshape(-1)[:block_len]

    return {
        "group_bytes": int(t.numel()), "rows": int(t.shape[0] * t.shape[1]),
        "k2_ms": k2,
        "verify_ms": clock(lambda: tiered._verify_resident(t, dig)),
        "d2h_ms": clock(lambda: tiered._to_host(t)),
        "copy_out_ms": clock(copy_out),
        "lookup_ms": clock(lambda: c.lookup(be, key, f"{key[0]}/{key[1]}")),
    }


def _prom_cache(signer) -> dict:
    """The miniotpu_cache_* samples of the server's Prometheus page."""
    st, _h, body = signer.request("GET", "/minio-tpu/prometheus/metrics")
    if st != 200:
        fail(f"read_cache: Prometheus answered {st}")
    out = {}
    for line in body.decode().splitlines():
        if line.startswith("miniotpu_cache_"):
            name, _sp, value = line.rpartition(" ")
            out[name] = float(value)
    return out


def read_cache_phase(dev, work: str, sel: dict) -> dict:
    """Phase 9b (slice 9a): the tiered read cache under the port's GET, on
    the S3 phase's deployment (threaded plane, 4 SigV4 clients, 12
    temp-dir disks, EC 8+4, 10 MiB blocks) with MINIO_TPU_READ_CACHE=device
    and RC_ENV.  A hot set of RC_HOT x 64 MiB PUT (populating the device
    tier) and read RC_GETS times over 4 clients; a one-shot scan of
    RC_COLD x 64 MiB that must leave every hot group on the device; one
    hot GET through the object layer with no shard or xl.meta read (K2
    counted); a byte flipped in a device-tier tensor caught by the hit's
    verification and re-admitted; a cleared cache and shards 1, 3, 10, 12
    offline (a degraded miss: K3 and K2, admitted with fresh digests);
    invalidation by overwrite, delete, heal and a metadata update; the
    admin clear, then Select Q1 over the 256 MiB lineitem object scanned
    from the device tier (no shard reader, K8-K11) against the host
    engine; admin stats, healthinfo and the miniotpu_cache_* families
    against the cache's stats; last the hot set's GET MB/s under ``host``
    and ``off`` beside ``device`` (the cache reset between modes)."""
    import hashlib

    import numpy as np
    import torch

    from minio_tpu_torch import cache as rcache
    from minio_tpu_torch.codec.telemetry import KERNEL_STATS
    from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
    from minio_tpu_torch.ops import kernels, select_step as ss
    from minio_tpu_torch.s3select import device as sdev
    from minio_tpu_torch.server.http import S3Server
    from minio_tpu_torch.storage.xl import XLStorage

    saved_env = {k: os.environ.get(k) for k in ("MINIO_TPU_READ_CACHE", *RC_ENV)}
    os.environ.update(RC_ENV)
    os.environ["MINIO_TPU_READ_CACHE"] = "device"
    os.environ.pop("MINIO_TPU_SELECT", None)
    rcache.reset_device_budget()
    rcache.reset_read_cache()
    roots = [os.path.join(work, f"rcdisk{i}") for i in range(N)]
    ol = ErasureObjects([XLStorage(r) for r in roots], parity_blocks=M,
                        block_size=BLOCK)
    srv = S3Server(ol, address="127.0.0.1:0").start()
    if srv.server_mode != "threaded":
        fail(f"read_cache: server plane {srv.server_mode}")
    host, port = srv.host, srv.port
    rng = np.random.default_rng(SEED + 9)
    hot = {f"hot{i}": rng.bytes(S3_BIG) for i in range(RC_HOT)}
    sha = {k: hashlib.sha256(v).digest() for k, v in hot.items()}
    hot_keys = sorted(hot)
    one = S3Signer(host, port)
    out: dict = {"objects_bytes": S3_BIG, "hot": RC_HOT, "cold": RC_COLD,
                 "env": dict(RC_ENV)}
    t_phase = time.monotonic()
    try:
        kernels.reset_launches()
        KERNEL_STATS.reset()
        st, _h, body = one.request("PUT", "/bench")
        if st != 200:
            fail(f"read_cache: bucket create {st} {body[:200]!r}")
        c = rcache.read_cache()
        if c is None or c.mode != "device" or c.device != ol.backend.device:
            fail(f"read_cache: the cache is {c and (c.mode, str(c.device))}")
        out["budget_before"] = rcache.device_budget().snapshot()

        def put(signer, key, data=None):
            data = hot[key] if data is None else data
            st, _h, body = signer.request("PUT", f"/bench/{key}", body=data,
                                          unsigned_payload=True)
            if st != 200:
                fail(f"read_cache: PUT {key}: {st} {body[:200]!r}")
            return key

        def get(signer, key, want=None):
            st, _h, body = signer.request("GET", f"/bench/{key}")
            want = sha[key] if want is None else want
            if st != 200 or hashlib.sha256(body).digest() != want:
                fail(f"read_cache: GET {key}: {st}, body differs from its source")
            return len(body)

        def passes(mode: str) -> dict:
            """The hot set read RC_GETS times, one pass a client."""
            jobs = [[hot_keys[(cl + j) % RC_HOT] for j in range(RC_HOT)]
                    for cl in range(S3_CLIENTS)][:RC_GETS]
            s0 = rcache.read_cache_stats()
            wall, sizes = _in_clients(host, port, jobs, get)
            s1 = rcache.read_cache_stats()
            return {"mode": mode, "gets": len(sizes), "bytes": sum(sizes),
                    "s": wall, "MBps": sum(sizes) / wall / 1e6,
                    "hits": {t: s1["tiers"][t]["hits"] - s0["tiers"][t]["hits"]
                             for t in rcache.TIERS},
                    "misses": {t: s1["tiers"][t]["misses"] - s0["tiers"][t]["misses"]
                               for t in rcache.TIERS}}

        # 1. the hot set: the PUT populates the device tier
        hot_jobs = [hot_keys[cl::S3_CLIENTS] for cl in range(S3_CLIENTS)]
        put_wall, _ = _in_clients(host, port, hot_jobs, put)
        groups = len(c._tiers["device"])
        want_groups = RC_HOT * len(range(0, S3_BIG, BLOCK * 4)) + RC_HOT
        if groups != want_groups:
            fail(f"read_cache: the PUTs left {groups} device groups, want {want_groups}")
        out["hot_put"] = {"s": put_wall, "MBps": RC_HOT * S3_BIG / put_wall / 1e6,
                          "device_groups": groups}
        dev_pass = passes("device")
        if dev_pass["hits"]["device"] != RC_GETS * groups or any(dev_pass["misses"].values()):
            fail(f"read_cache: the hot GETs were not all device hits: {dev_pass}")
        modes = {"device": dev_pass}

        # 2. a one-shot scan must not displace the hot set
        hot_dev = {k for k in c._tiers["device"]}
        cold = [f"cold{i}" for i in range(RC_COLD)]
        cold_sha = {}

        def cold_put_get(signer, key):
            data = np.random.default_rng([SEED, 99, int(key[4:])]).bytes(S3_BIG)
            cold_sha[key] = hashlib.sha256(data).digest()
            put(signer, key, data)
            return get(signer, key, cold_sha[key])

        s0 = rcache.read_cache_stats()
        cold_wall, _ = _in_clients(host, port, [cold[cl::S3_CLIENTS] for cl in
                                                range(S3_CLIENTS)], cold_put_get)
        s1 = rcache.read_cache_stats()
        lost = hot_dev - set(c._tiers["device"])
        if lost:
            fail(f"read_cache: the cold scan displaced {len(lost)} hot device groups")
        after = passes("device (after the cold scan)")
        if after["hits"]["device"] != RC_GETS * groups or any(after["misses"].values()):
            fail(f"read_cache: hot GETs after the cold scan: {after}")
        out["cold_scan"] = {
            "s": cold_wall, "MBps": 2 * RC_COLD * S3_BIG / cold_wall / 1e6,
            "rejects": {t: s1["tiers"][t]["rejects"] - s0["tiers"][t]["rejects"]
                        for t in rcache.TIERS},
            "evictions": {t: s1["tiers"][t]["evictions"] - s0["tiers"][t]["evictions"]
                          for t in rcache.TIERS},
            "demotions": s1["demotions"] - s0["demotions"],
            "admission": {k: s1["admission"][k] - s0["admission"][k]
                          for k in s1["admission"]},
            "stats_after": s1, "hot_after": after}

        # 3. a full hit through the object layer reads no shard, no xl.meta
        calls0 = _disk_calls(ol.disks)
        k2 = kernels.LAUNCHES["phash256_batched"]
        h0 = rcache.read_cache_stats()["tiers"]["device"]["hits"]
        buf = io.BytesIO()
        t0 = time.monotonic()
        ol.get_object("bench", "hot0", buf)
        hit_s = time.monotonic() - t0
        moved = _moved(calls0, _disk_calls(ol.disks))
        k2_hit = kernels.LAUNCHES["phash256_batched"] - k2
        per_obj = groups // RC_HOT
        if hashlib.sha256(buf.getvalue()).digest() != sha["hot0"]:
            fail("read_cache: the object layer's hit differs from its source")
        if set(moved) - {"stat_vol"} or moved.get("stat_vol", 0) > 1:
            fail(f"read_cache: a full hit moved the disks' counters {moved}")
        if (k2_hit != per_obj
                or rcache.read_cache_stats()["tiers"]["device"]["hits"] - h0 != per_obj):
            fail(f"read_cache: a full hit launched K2 {k2_hit} times for {per_obj} groups")
        calls0 = _disk_calls(ol.disks)
        get(one, "hot0")
        out["full_hit"] = {"object_layer_disk_calls": moved, "k2_launches": k2_hit,
                           "groups": per_obj, "s": hit_s,
                           "s3_get_disk_calls": _moved(calls0, _disk_calls(ol.disks))}
        first = min(k for k in c._tiers["device"] if k[1] == "hot0")
        out["hit_breakdown"] = hit_breakdown(c, ol.backend, first)
        ol_get = {"device": _ol_get_s(ol, "hot0")}

        # 4. rot in a device-tier tensor: dropped, counted, served from disk
        key = next(k for k in c._tiers["device"] if k[1] == "hot1")
        c._tiers["device"][key].data[0, 0, 0] ^= 0xFF
        s0 = rcache.read_cache_stats()
        get(one, "hot1")
        s1 = rcache.read_cache_stats()
        if (s1["verify_drops"] - s0["verify_drops"] != 1
                or key not in c._tiers["device"]):
            fail(f"read_cache: the rotted group: drops "
                 f"{s1['verify_drops'] - s0['verify_drops']}, readmitted "
                 f"{key in c._tiers['device']}")
        out["rot"] = {"verify_drops": s1["verify_drops"] - s0["verify_drops"],
                      "readmitted": True}

        # 5. a degraded miss: K3 rebuilds, K2 digests the rebuilt rows
        rcache.clear_read_cache()
        dist = XLStorage(roots[0]).read_version("bench", "hot2").erasure.distribution
        dead = sorted(d for d in range(N) if dist[d] in (1, 3, 10, 12))
        live = list(ol.disks)
        for d in dead:
            ol.disks[d] = None
        try:
            before = dict(kernels.LAUNCHES)
            get(one, "hot2")
            deg = _moved(before, dict(kernels.LAUNCHES))
        finally:
            ol.disks[:] = live
        admitted = [k for k in c._tiers["device"] if k[1] == "hot2"]
        if (not deg.get("gf_matmul_words") or not deg.get("phash256_batched")
                or len(admitted) != per_obj):
            fail(f"read_cache: the degraded miss launched {deg}, admitted {len(admitted)}")
        s0 = rcache.read_cache_stats()
        get(one, "hot2")
        s1 = rcache.read_cache_stats()
        if (s1["tiers"]["device"]["hits"] - s0["tiers"]["device"]["hits"] != per_obj
                or s1["tiers"]["device"]["misses"] != s0["tiers"]["device"]["misses"]):
            fail("read_cache: the GET after the degraded miss was not a device hit")
        out["degraded_miss"] = {"offline_disks": dead, "launches": deg,
                                "admitted_groups": len(admitted)}

        # 6. invalidation: overwrite, delete, heal, metadata update
        inv0 = rcache.read_cache_stats()["invalidations"]
        new = np.random.default_rng(SEED + 10).bytes(S3_BIG)
        get(one, "hot3")
        put(one, "hot3", new)
        get(one, "hot3", hashlib.sha256(new).digest())
        get(one, "hot4")
        st, _h, _b = one.request("DELETE", "/bench/hot4")
        st2, _h, _b = one.request("GET", "/bench/hot4")
        if (st, st2) != (204, 404):
            fail(f"read_cache: DELETE then GET answered {st}, {st2}")
        put(one, "hot4")  # back in the hot set for the modes' passes
        get(one, "hot5")
        dist5 = XLStorage(roots[0]).read_version("bench", "hot5").erasure.distribution
        shutil.rmtree(os.path.join(roots[dist5.index(2)], "bench", "hot5"))
        inv1 = rcache.read_cache_stats()["invalidations"]
        healed = ol.heal_object("bench", "hot5")["healed"]
        inv_heal = rcache.read_cache_stats()["invalidations"] - inv1
        if not healed or inv_heal != 1:
            fail(f"read_cache: heal_object healed {healed}, invalidations +{inv_heal}")
        get(one, "hot6")
        if c.meta_lookup("bench", "hot6") is None:
            fail("read_cache: a GET stored no FileInfo side-car entry")
        ol.update_object_meta("bench", "hot6", {"x-amz-tagging": "k=v"})
        if c.meta_lookup("bench", "hot6") is not None:
            fail("read_cache: update_object_meta left the side-car entry")
        out["invalidation"] = {
            "invalidations": rcache.read_cache_stats()["invalidations"] - inv0,
            "healed_shards": healed}
        sha["hot3"] = hashlib.sha256(new).digest()
        hot["hot3"] = new

        # 7. the admin clear, then Select Q1 scanned from the device tier
        st, _h, body = one.request("POST", f"{ADMIN}/read-cache-clear")
        cleared = json.loads(body) if st == 200 else None
        left = rcache.read_cache_stats()["tiers"]
        if not cleared or not cleared.get("cleared") or any(
                left[t]["entries"] for t in rcache.TIERS):
            fail(f"read_cache: read-cache-clear answered {st} {body[:200]!r}")
        big = lineitem_csv(SEED + 6, SELECT_OBJECT)
        put(one, "lineitem.csv", big)
        readers = {"opened": 0}
        part_readers = ol._part_readers

        def counted(*a, **kw):
            readers["opened"] += 1
            return part_readers(*a, **kw)

        ol._part_readers = counted
        try:
            src = ol.device_scan_source("bench", "lineitem.csv")
            if src is None or src[0].device != ol.backend.device:
                fail("read_cache: device_scan_source found no plane on the card")
            del src
            before = dict(kernels.LAUNCHES)
            s0 = sdev.STATS.snapshot()
            t0 = time.monotonic()
            st, _h, body = one.request(
                "POST", "/bench/lineitem.csv", {"select": "", "select-type": "2"},
                select_body(SELECT_QUERIES["Q1"]))
            took = time.monotonic() - t0
            s1 = sdev.STATS.snapshot()
            launched = _moved(before, dict(kernels.LAUNCHES))
            opened = readers["opened"]
        finally:
            ol._part_readers = part_readers
        if st != 200:
            fail(f"read_cache: Q1 from the device tier answered {st} {body[:200]!r}")
        recs, _k = select_records(body)
        os.environ["MINIO_TPU_SELECT"] = "host"
        try:
            st, _h, hbody = one.request(
                "POST", "/bench/lineitem.csv", {"select": "", "select-type": "2"},
                select_body(SELECT_QUERIES["Q1"]))
        finally:
            os.environ.pop("MINIO_TPU_SELECT", None)
        hrecs, _k = select_records(hbody)
        if st != 200 or recs != hrecs or not recs:
            fail(f"read_cache: Q1 from the device tier differs from the host "
                 f"engine's ({len(recs)} and {len(hrecs)} bytes)")
        if opened or any(not launched.get(n) for n in ss.LAUNCH_NAMES
                         if n != "select_spans[back]"):
            fail(f"read_cache: Q1 from the device tier opened {opened} shard "
                 f"readers, launched {launched}")
        spooled = sel["queries"]["Q1"]["device"]
        out["select_Q1"] = {
            "s": took, "MBps": len(big) / took / 1e6,
            "device_seconds": s1["device_seconds"] - s0["device_seconds"],
            "fallbacks": _moved(s0["fallbacks"], s1["fallbacks"]),
            "shard_readers_opened": opened, "launches": launched,
            "records_bytes": len(recs),
            "spooled_s": spooled["s"], "spooled_device_seconds": spooled["device_seconds"]}

        # 8. admin stats, healthinfo and Prometheus agree with stats()
        stats = rcache.read_cache_stats()
        st, _h, body = one.request("GET", f"{ADMIN}/read-cache-stats")
        st2, _h, hbody = one.request("GET", f"{ADMIN}/healthinfo")
        prom = _prom_cache(one)
        node = json.loads(hbody)["nodes"][0] if st2 == 200 else {}
        want_prom = {f'miniotpu_cache_{f}{{tier="{t}"}}': float(stats["tiers"][t][k])
                     for t in rcache.TIERS
                     for f, k in (("hits_total", "hits"), ("misses_total", "misses"),
                                  ("entries", "entries"),
                                  ("occupancy_bytes", "occupancy_bytes"),
                                  ("budget_bytes", "capacity_bytes"))}
        want_prom["miniotpu_cache_invalidations_total"] = float(stats["invalidations"])
        want_prom["miniotpu_cache_demotions_total"] = float(stats["demotions"])
        if (st != 200 or json.loads(body) != stats
                or node.get("read_cache") != stats
                or any(prom.get(k) != v for k, v in want_prom.items())):
            fail(f"read_cache: admin/healthinfo/Prometheus disagree with stats(): "
                 f"{st} {st2} {[k for k, v in want_prom.items() if prom.get(k) != v]}")
        out["stats"] = stats
        out["budget"] = rcache.device_budget().snapshot()
        out["launches_device_part"] = dict(kernels.LAUNCHES)
        st, _h, _b = one.request("DELETE", "/bench/lineitem.csv")

        # the same hot GETs under host and off (the cache reset between)
        for mode in ("host", "off"):
            os.environ["MINIO_TPU_READ_CACHE"] = mode
            rcache.reset_read_cache()
            # the host tier fills on its first pass (every GET a miss)
            warm = passes(mode + " (first pass)") if mode == "host" else None
            modes[mode] = passes(mode)
            if warm is not None:
                modes[mode]["first_pass"] = warm
            ol_get[mode] = _ol_get_s(ol, "hot0")
        out["object_layer_get_s"] = ol_get
        if modes["host"]["hits"]["host"] != RC_GETS * groups:
            fail(f"read_cache: the host tier's GETs were not all hits: {modes['host']}")
        if rcache.read_cache() is not None:
            fail("read_cache: off mode built a cache")
        out["modes"] = modes
        out["phase_s"] = time.monotonic() - t_phase
        out["launches"] = {k: v for k, v in kernels.LAUNCHES.items() if v}
    finally:
        one.close()
        srv.shutdown()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        rcache.reset_read_cache()
        rcache.reset_device_budget()
        for r in roots:
            shutil.rmtree(r, ignore_errors=True)
        torch.cuda.empty_cache()
    for name in ("encode_pack_pipelined", "phash256_batched", "gf_matmul_words",
                 "verify_reconstruct_pipelined", "encode_pack[group=0]",
                 *(n for n in ss.LAUNCH_NAMES if n != "select_spans[back]")):
        if not out["launches"].get(name):
            fail(f"read_cache: kernel {name} never launched")
    return out


# ---------------------------------------------------------------------------
# slice 9b: four nodes, one erasure set (the cluster phase)
# ---------------------------------------------------------------------------

CLUSTER_NODES = 4
CLUSTER_DRIVES = 4  # per node: 16 drives, one set, EC 8+8 (default parity)
# 64 MiB objects PUT through each node's client; cut from 4 to make room
# for the web phase
CLUSTER_PER_NODE = 2
CLUSTER_RACE_ROUNDS = 2  # cut from 8, then 4, to make room for the parity_ack and mesh phases
CLUSTER_RACE_SIZE = 16 << 20
CLUSTER_RAW_ROUNDS = 2  # cut from 20 (15.7 s), then 10, 6 and 4, to keep 4 grid cells, the mesh and analysis phases
CLUSTER_HOT_SIZE = 8 << 20
CLUSTER_DOWN_PUTS = 3  # objects PUT with node 4 killed, one a live node (cut from 4)
CLUSTER_READY_S = 300.0  # spawn to ready, CUDA start and library load included
CLUSTER_BUCKET = "cluster"
# node 1 serves GETs through the tiered read cache, its hot tier on the card
CLUSTER_CACHE_ENV = {"MINIO_TPU_READ_CACHE": "device",
                     "MINIO_TPU_READ_CACHE_DEVICE_MB": "1024",
                     "MINIO_TPU_READ_CACHE_MB": "1024",
                     "MINIO_TPU_DEVICE_BUDGET_MB": "2048"}


def _obj_state(root: str, key: str, bucket: str = CLUSTER_BUCKET) -> dict:
    """One drive's copy of an object: the sha256 of each part file under
    the version's data dir, and xl.meta's erasure geometry, parts, size
    and ETag (mod time, data dir and version id are fresh every PUT)."""
    import hashlib

    from minio_tpu_torch.storage.xl import XLStorage

    fi = XLStorage(root).read_version(bucket, key)
    ddir = os.path.join(root, bucket, key, fi.data_dir)
    parts = {}
    for name in sorted(os.listdir(ddir)):
        with open(os.path.join(ddir, name), "rb") as f:
            parts[name] = hashlib.sha256(f.read()).hexdigest()
    return {"parts": parts, "erasure": fi.erasure.to_dict(),
            "part_sizes": [p.to_dict() for p in fi.parts], "size": fi.size,
            "etag": fi.metadata.get("etag")}


def _obj_bytes(root: str, key: str) -> int:
    base = os.path.join(root, CLUSTER_BUCKET, key)
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _s, files in os.walk(base) for f in files)


def cluster_phase(work: str, backend: "str | None" = None) -> dict:
    """Phase 11 (slice 9b): four ``python -m minio_tpu_torch.server``
    processes on this one card, started by the port's ClusterHarness with
    the same 16 ``http://127.0.0.1:P_j/.../d{1..4}`` endpoints: one
    erasure set of 16 drives at the default parity (EC 8+8), the
    4-node, 4-drive layout of MinIO's distributed-mode guide, on the
    async plane with the harness's fast lock and heal cadences; node 1
    serves GETs through the device-tier read cache.  Boot, 4 clients
    (client i on node i), a PUT race through the lock plane, cross-node
    read-after-write, node 4 killed and restarted, an admin heal, and
    SIGTERM.  ``backend`` sets MINIO_ERASURE_BACKEND for a rehearsal on
    the CPU."""
    import hashlib
    import json as _json
    import threading

    import numpy as np

    from minio_tpu_torch.cluster.harness import ClusterHarness
    from minio_tpu_torch.codec.erasure import BLOCK_SIZE_V1
    from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
    from minio_tpu_torch.storage.meta import XLMeta
    from minio_tpu_torch.storage.xl import XLStorage

    base = os.path.join(work, "cluster")
    # the phase holds node 4's drives empty of the PUTs it missed until
    # the admin heal: a background crawl (every 60 s by default) would
    # queue those heals itself at a moment the phase does not choose, so
    # the nodes' crawlers wait past the phase (bucket_config drives one)
    env = {"MINIO_TPU_SERVER": "async", "MINIO_TPU_LOG_LEVEL": "warning",
           "MINIO_TPU_CRAWL_INTERVAL_S": "3600"}
    if backend is not None:
        env["MINIO_ERASURE_BACKEND"] = backend
    h = ClusterHarness(base, nodes=CLUSTER_NODES,
                       drives_per_node=CLUSTER_DRIVES, env=env,
                       fault_injection=False,
                       format_timeout_s=CLUSTER_READY_S)
    roots = [str(d) for n in h.nodes for d in n.drive_dirs]
    node_of = [j // CLUSTER_DRIVES for j in range(len(roots))]
    bkt = CLUSTER_BUCKET
    rng = np.random.default_rng(SEED + 20)
    objs = {f"n{i + 1}/big{j}": rng.bytes(S3_BIG)
            for i in range(CLUSTER_NODES) for j in range(CLUSTER_PER_NODE)}
    sha = {k: hashlib.sha256(v).hexdigest() for k, v in objs.items()}
    out: dict = {"nodes": CLUSTER_NODES, "drives": len(roots)}

    def tail(i: int) -> str:
        return h.nodes[i].log_tail(3000)

    def signer(i: int) -> S3Signer:
        return S3Signer("127.0.0.1", h.nodes[i].port)

    def admin(i: int, method: str, tail_: str, query=None) -> dict:
        s = signer(i)
        try:
            st, _h, body = s.request(method, f"{ADMIN}/{tail_}", query)
        finally:
            s.close()
        if st != 200:
            fail(f"cluster: node {i + 1} admin {method} {tail_}: {st} "
                 f"{body[:2000]!r}; its log: {tail(i)}")
        return _json.loads(body) if body else {}

    def launches(nodes) -> dict:
        return {i: admin(i, "GET", "kernel-stats")["launches"] for i in nodes}

    def delta(a: dict, b: dict) -> dict:
        return {i: {k: b[i][k] - a[i].get(k, 0) for k in b[i]
                    if b[i][k] != a[i].get(k, 0)} for i in b}

    def by_node(jobs: dict, fn) -> "tuple[float, list]":
        """``fn(signer, job)`` for each node's jobs, one client thread per
        node at once; (wall seconds, results)."""
        results: dict = {}
        errors: list = []
        start = threading.Barrier(len(jobs) + 1)

        def run(i):
            s = signer(i)
            try:
                start.wait()
                results[i] = [fn(s, job) for job in jobs[i]]
            except BaseException as e:  # noqa: BLE001 - reported below
                errors.append(e)
            finally:
                s.close()

        threads = [threading.Thread(target=run, args=(i,)) for i in jobs]
        for t in threads:
            t.start()
        start.wait()
        t0 = time.monotonic()
        for t in threads:
            t.join()
        wall = time.monotonic() - t0
        if errors:
            fail(f"cluster: a client failed: {errors[0]!r}")
        return wall, [r for i in sorted(results) for r in results[i]]

    def put(s, job):
        key, data = job
        st, _h, body = s.request("PUT", f"/{bkt}/{key}", body=data,
                                 payload_hash=hashlib.sha256(data).hexdigest())
        if st != 200:
            fail(f"cluster: PUT {key} on {s.port}: {st} {body[:300]!r}")
        return len(data)

    def get_sha(s, job):
        key, want = job
        st, _h, body = s.request("GET", f"/{bkt}/{key}")
        if st != 200 or hashlib.sha256(body).hexdigest() != want:
            fail(f"cluster: GET {key} on {s.port}: {st}, body differs")
        return len(body)

    def wait_ready(idx, t_spawn) -> dict:
        import http.client

        ready: dict = {}
        while len(ready) < len(idx):
            for i in idx:
                if i in ready:
                    continue
                node = h.nodes[i]
                if not node.alive():
                    fail(f"cluster: node {i + 1} exited "
                         f"{node.proc.returncode}: {tail(i)}")
                if time.monotonic() - t_spawn[i] > CLUSTER_READY_S:
                    fail(f"cluster: node {i + 1} not ready within "
                         f"{CLUSTER_READY_S} s: {tail(i)}")
                try:
                    conn = http.client.HTTPConnection("127.0.0.1", node.port,
                                                      timeout=5)
                    conn.request("GET", "/minio/health/ready")
                    if conn.getresponse().status == 200:
                        ready[i] = time.monotonic() - t_spawn[i]
                    conn.close()
                except OSError:
                    pass
            time.sleep(0.05)
        return ready

    def no_locks(nodes) -> None:
        deadline = time.monotonic() + 15
        for i in nodes:
            while True:
                locks = admin(i, "GET", "top-locks")["locks"]
                if not locks:
                    break
                if time.monotonic() > deadline:
                    fail(f"cluster: node {i + 1} top-locks not empty: "
                         f"{locks[:4]}")
                time.sleep(0.1)

    ref_roots = [os.path.join(work, "cluster-ref", f"d{j}")
                 for j in range(len(roots))]
    ref = None

    def hold(keys_data: dict, what: str) -> int:
        """Every drive's part files and xl.meta against the port's plain
        CPU codec writing the same bytes on 16 drives of its own."""
        nonlocal ref
        if ref is None:
            ref = ErasureObjects([XLStorage(r) for r in ref_roots],
                                 parity_blocks=len(roots) // 2,
                                 block_size=BLOCK_SIZE_V1, device="cpu")
            ref.make_bucket(bkt)
        for key, data in keys_data.items():
            ref.put_object(bkt, key, io.BytesIO(data), len(data))
            for j, (r, c) in enumerate(zip(ref_roots, roots)):
                want, got = _obj_state(r, key), _obj_state(c, key)
                if got != want:
                    fail(f"cluster: {what}: {key} on drive {j + 1} (node "
                         f"{node_of[j] + 1}) differs from the plain codec's")
        return len(keys_data) * len(roots)

    t_phase = time.monotonic()
    try:
        # -- 1. boot all four at once ---------------------------------------
        t_spawn = {}
        for i in range(CLUSTER_NODES):
            t_spawn[i] = time.monotonic()
            h.spawn(i, extra_env=CLUSTER_CACHE_ENV if i == 0 else None)
        ready = wait_ready(range(CLUSTER_NODES), t_spawn)
        out["spawn_to_ready_s"] = [ready[i] for i in range(CLUSTER_NODES)]
        fmts = []
        for r in roots:
            with open(os.path.join(r, ".sys", "format.json")) as f:
                fmts.append(_json.load(f))
        sets = fmts[0]["erasure"]["sets"]
        if ({f["id"] for f in fmts} != {fmts[0]["id"]}
                or any(f["erasure"]["sets"] != sets for f in fmts)
                or len(sets) != 1 or len(sets[0]) != len(roots)
                or [f["erasure"]["this"] for f in fmts] != sets[0]):
            fail("cluster: the 16 drives disagree on format.json")
        info = admin(0, "GET", "info")
        if info.get("mode") != "distributed" or [
                n.get("state") for n in info.get("nodes", [])] != ["online"] * 3:
            fail(f"cluster: admin info {info.get('mode')} {info.get('nodes')}")
        s = signer(0)
        st, _h, body = s.request("PUT", f"/{bkt}")
        s.close()
        if st != 200:
            fail(f"cluster: bucket create {st} {body[:200]!r}")

        # -- 2. 4 clients, client i on node i: PUT, then GET elsewhere ------
        keys = sorted(objs)
        mine = {i: [k for k in keys if k.startswith(f"n{i + 1}/")]
                for i in range(CLUSTER_NODES)}
        # a ListenBucketNotification stream on node 1: the other nodes'
        # PUTs reach it through their peer planes (listenon/listenbuf)
        stream = ListenStream("127.0.0.1", h.nodes[0].port, bkt,
                              {"events": "s3:ObjectCreated:*"})
        deadline = time.monotonic() + 30
        while [admin(i, "GET", "listen-stats")["remote"]
               for i in range(1, CLUSTER_NODES)] != [1] * (CLUSTER_NODES - 1):
            if time.monotonic() > deadline:
                stream.close()
                fail("cluster: node 1's listen never registered on its peers")
            time.sleep(0.05)
        l0 = launches(range(CLUSTER_NODES))
        t_put = time.monotonic()
        put_wall, put_sizes = by_node(
            {i: [(k, objs[k]) for k in mine[i]] for i in mine}, put)
        deadline = time.monotonic() + 30
        while len(stream.records) < len(keys) and time.monotonic() < deadline:
            time.sleep(0.05)
        stream.close()
        heard = sorted(rec["Key"] for _t, rec in stream.records)
        if heard != sorted(f"{bkt}/{k}" for k in keys) or any(
                rec["EventName"] != "s3:ObjectCreated:Put"
                for _t, rec in stream.records):
            fail(f"cluster: node 1's listen stream heard {heard}")
        # the stream's end unsubscribes it on every peer (listenoff)
        deadline = time.monotonic() + 30
        while admin(2, "GET", "listen-stats")["remote"]:
            if time.monotonic() > deadline:
                fail("cluster: node 3 still holds node 1's listener")
            time.sleep(0.05)
        out["listen"] = {
            "records": len(heard),
            "from_peers": sum(not k.startswith(f"{bkt}/n1/") for k in heard),
            "last_s": max(t for t, _r in stream.records) - t_put,
            "node3_listeners_after": admin(2, "GET", "listen-stats")}
        l1 = launches(range(CLUSTER_NODES))
        get_wall, get_sizes = by_node(
            {(i + 1) % CLUSTER_NODES: [(k, sha[k]) for k in mine[i]]
             for i in mine}, get_sha)
        l2 = launches(range(CLUSTER_NODES))
        internode = [sum(_obj_bytes(roots[j], k) for j in range(len(roots))
                         if node_of[j] != i)
                     for i in mine for k in mine[i]]
        stored = [sum(_obj_bytes(r, k) for r in roots) for k in keys]
        put_l, get_l = delta(l0, l1), delta(l1, l2)
        for i in range(CLUSTER_NODES):
            if not put_l[i].get("encode_pack_pipelined"):
                fail(f"cluster: K5 did not launch on node {i + 1}'s PUTs: "
                     f"{put_l[i]}")
            if not get_l[i].get("phash256_batched"):
                fail(f"cluster: K2 did not launch on node {i + 1}'s GETs: "
                     f"{get_l[i]}")

        # -- 3. the 16 drives against the plain CPU codec -------------------
        first = keys[0]
        t0 = time.monotonic()
        held = hold({first: objs[first]}, "PUT")
        hold_s = time.monotonic() - t0

        # -- 4. a PUT race on one key through nodes 1 and 3 ------------------
        race = [rng.bytes(CLUSTER_RACE_SIZE) for _ in range(2)]
        race_sha = {hashlib.sha256(b).hexdigest() for b in race}
        winners = []
        t0 = time.monotonic()
        for _r in range(CLUSTER_RACE_ROUNDS):
            by_node({0: [("race", race[0])], 2: [("race", race[1])]}, put)
            s = signer(1)
            st, _h, body = s.request("GET", f"/{bkt}/race")
            s.close()
            got = hashlib.sha256(body).hexdigest()
            if st != 200 or got not in race_sha:
                fail(f"cluster: race GET {st}: neither body")
            winners.append(0 if got == hashlib.sha256(race[0]).hexdigest()
                           else 2)
            metas = [XLMeta.from_bytes(open(os.path.join(
                r, bkt, "race", "xl.meta"), "rb").read()) for r in roots]
            if any(len(m.versions) != 1 for m in metas) or len(
                    {(m.versions[0].data_dir, m.versions[0].metadata.get("etag"))
                     for m in metas}) != 1:
                fail("cluster: the race left more than one xl.meta generation")
        race_s = time.monotonic() - t0
        no_locks(range(CLUSTER_NODES))
        objs["race"] = race[winners[-1] // 2]
        sha["race"] = hashlib.sha256(objs["race"]).hexdigest()

        # -- 5. read-after-write across nodes (node 1 caches, node 2 writes)
        hot = [rng.bytes(CLUSTER_HOT_SIZE) for _ in range(CLUSTER_RAW_ROUNDS + 1)]
        rc0 = admin(0, "GET", "read-cache-stats")
        s1, s2 = signer(0), signer(1)
        put(s2, ("hot", hot[0]))
        fresh, hits = 0, 0
        t0 = time.monotonic()
        for r in range(CLUSTER_RAW_ROUNDS):
            before = admin(0, "GET", "read-cache-stats")
            for _ in range(2):
                st, _h, body = s1.request("GET", f"/{bkt}/hot")
                if st != 200 or body != hot[r]:
                    fail(f"cluster: round {r}: node 1's GET of the hot object")
            after = admin(0, "GET", "read-cache-stats")
            hits += (after["tiers"]["device"]["hits"]
                     > before["tiers"]["device"]["hits"])
            put(s2, ("hot", hot[r + 1]))
            st, _h, body = s1.request("GET", f"/{bkt}/hot")
            if st != 200 or body != hot[r + 1]:
                fail(f"cluster: read-after-write broken in round {r + 1}: "
                     f"node 1 returned {'the old body' if body == hot[r] else st}")
            fresh += 1
        raw_s = time.monotonic() - t0
        s1.close()
        s2.close()
        rc1 = admin(0, "GET", "read-cache-stats")
        if not hits:
            fail("cluster: node 1 never served the hot object from the device tier")
        objs["hot"] = hot[-1]
        sha["hot"] = hashlib.sha256(hot[-1]).hexdigest()

        # -- 6. node 4 killed: degraded GETs, PUTs at quorum, restart, heal --
        h.kill(3)
        up = range(CLUSTER_NODES - 1)
        l3 = launches(up)
        big = sorted(k for k in objs if k.startswith("n"))
        down_wall, down_sizes = by_node(
            {i: [(k, sha[k]) for k in big[i::len(up)]] for i in up}, get_sha)
        l4 = launches(up)
        down_l = delta(l3, l4)
        if not any(down_l[i].get("gf_matmul_words") for i in up):
            fail(f"cluster: K3 never launched with node 4 down: {down_l}")
        down_objs = {f"down/k{j}": rng.bytes(BLOCK_SIZE_V1 + 17 + j)
                     for j in range(CLUSTER_DOWN_PUTS)}
        for j, (k, v) in enumerate(down_objs.items()):
            by_node({j % len(up): [(k, v)]}, put)
        objs.update(down_objs)
        sha.update({k: hashlib.sha256(v).hexdigest()
                    for k, v in down_objs.items()})
        early = [k for k in down_objs for j in range(len(roots))
                 if node_of[j] == 3
                 and os.path.exists(os.path.join(roots[j], bkt, k, "xl.meta"))]
        if early:
            fail(f"cluster: node 4's drives hold {early} PUT while it was down")
        t_spawn = {3: time.monotonic()}
        h.spawn(3)
        restart_s = wait_ready([3], t_spawn)[3]
        # node 1 probes a drive that went down again only every few
        # seconds: heal once it counts all 16 drives online, breakers closed.
        # A tripped drive's breaker closes on the first call that reaches
        # it after its backoff (up to 30 s), so a client keeps reading
        # xl.meta of one object through node 1 (a HEAD touches every
        # drive) while it waits
        t0 = time.monotonic()
        s_head = signer(0)
        while True:
            st, _h, _b = s_head.request("HEAD", f"/{bkt}/{big[0]}")
            if st != 200:
                fail(f"cluster: HEAD through node 1 after node 4's restart: {st}")
            si = admin(0, "GET", "storageinfo")
            online = sum(st["online"] for z in si["zones"] for st in z["sets"])
            states = h.disk_states(0)
            if (online == len(roots) and len(states) == len(roots)
                    and not any(states.values())):
                break
            if time.monotonic() - t0 > 60:
                fail(f"cluster: node 1 sees {online} of {len(roots)} drives "
                     f"online 60 s after node 4's restart; breakers {states}")
            time.sleep(0.1)
        s_head.close()
        reprobe_s = time.monotonic() - t0
        l5 = launches([0])
        t0 = time.monotonic()
        healed = {}
        for k in down_objs:
            res = admin(0, "POST", "heal", {"bucket": bkt, "object": k})
            healed[k] = res.get("healed", res)
        heal_s = time.monotonic() - t0
        heal_l = delta(l5, launches([0]))[0]
        for name in ("verify_reconstruct_pipelined", "encode_pack[group=0]"):
            if not heal_l.get(name):
                fail(f"cluster: {name} did not launch in node 1's heal: {heal_l}")
        held += hold(down_objs, "heal")

        # -- every acknowledged object from every node ------------------------
        l6 = launches(range(CLUSTER_NODES))
        all_keys = sorted(objs)
        all_wall, all_sizes = by_node(
            {i: [(k, sha[k]) for k in all_keys] for i in range(CLUSTER_NODES)},
            get_sha)
        l7 = launches(range(CLUSTER_NODES))
        no_locks(range(CLUSTER_NODES))
        node_launches = {f"node{i + 1}": v for i, v in delta(l0, l7).items()}
        rc2 = admin(0, "GET", "read-cache-stats")

        # -- 7. SIGTERM all four ----------------------------------------------
        sigterm_s = []
        for i in range(CLUSTER_NODES):
            t0 = time.monotonic()
            rc = h.terminate(i, timeout_s=120)
            sigterm_s.append(time.monotonic() - t0)
            if rc != 0 or "shutdown complete" not in tail(i):
                fail(f"cluster: node {i + 1} SIGTERM exit {rc}: {tail(i)}")
    finally:
        h.stop()
        shutil.rmtree(os.path.join(work, "cluster-ref"), ignore_errors=True)
    nput, nget = sum(put_sizes), sum(get_sizes)
    ndown, nall = sum(down_sizes), sum(all_sizes)
    out.update({
        "phase_s": time.monotonic() - t_phase,
        "geometry": {"data": 8, "parity": 8},
        "put": {"bytes": nput, "s": put_wall, "MBps": nput / put_wall / 1e6},
        "get_other_node": {"bytes": nget, "s": get_wall,
                           "MBps": nget / get_wall / 1e6},
        "get_node_down": {"bytes": ndown, "s": down_wall,
                          "MBps": ndown / down_wall / 1e6},
        "get_every_node": {"bytes": nall, "s": all_wall,
                           "MBps": nall / all_wall / 1e6},
        "internode_put_bytes_per_object": sum(internode) / len(internode),
        "stored_bytes_per_object": sum(stored) / len(stored),
        "held_drive_copies": held, "hold_s": hold_s,
        "race": {"rounds": CLUSTER_RACE_ROUNDS, "bytes": CLUSTER_RACE_SIZE,
                 "winners": [w + 1 for w in winners], "s": race_s},
        "read_after_write": {
            "rounds": CLUSTER_RAW_ROUNDS, "fresh": fresh,
            "rounds_with_device_hits": hits, "s": raw_s,
            "node1_invalidations": rc1["invalidations"] - rc0["invalidations"],
            "node1_device_hits": rc1["tiers"]["device"]["hits"]
            - rc0["tiers"]["device"]["hits"]},
        "restart_ready_s": restart_s,
        "restart_to_all_online_s": reprobe_s,
        "heal": {"objects": len(down_objs), "s": heal_s, "healed": healed,
                 "launches": heal_l},
        "launches": {"put": put_l, "get": get_l, "node_down_get": down_l,
                     "per_node": node_launches},
        "node1_read_cache": {k: rc2[k] for k in ("mode", "invalidations",
                                                 "demotions", "verify_drops")},
        "sigterm_s": sigterm_s,
    })
    return out


# -- phase 12: resumable heal sequences (slice 9d) --------------------------

HS_OBJECTS = 6  # objects of S3_BIG, 384 MiB (cut from 16, then 8, to keep 4 grid cells)
HS_WIPED = (2, 9)  # drives whose payload is wiped, .sys kept
HS_RESTART_WIPED = (5,)  # wiped again before the stop / force-start round
HS_BUCKET = "healseq"
HS_POLL_S = 0.25


def _wipe_payload(root: str) -> None:
    """A replaced drive that kept its format: everything but .sys goes."""
    for entry in os.listdir(root):
        if entry != ".sys":
            shutil.rmtree(os.path.join(root, entry), ignore_errors=True)


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def _admin_error(body: bytes) -> str:
    codes = _xml_text(body, "Code")
    return codes[0] if codes else body[:200].decode(errors="replace")


def heal_seq_phase(dev, work: str, heal_object_MBps: float) -> dict:
    """Phase 12 (slice 9d): admin heal sequences on the S3 phase's
    deployment - the port's S3Server (threaded plane) over 12 disks at EC
    8+4 with 10 MiB blocks on the card, SigV4 admin calls.  HS_OBJECTS x
    64 MiB objects, two drives' payload wiped (``.sys`` kept); a dry run reports
    without writing; a sequence launched over the bucket and polled by its
    client token heals every object back to byte-equal part files and
    xl.meta, answering HealAlreadyRunning, HealOverlappingPaths and
    HealInvalidClientToken while it runs; then a third drive wiped, the
    sequence stopped in mid-walk and a forceStart launch healing the rest.
    ``heal_object_MBps`` is this run's heal phase rate, printed beside."""
    import json as _json

    import numpy as np

    from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
    from minio_tpu_torch.ops import kernels
    from minio_tpu_torch.server.http import S3Server
    from minio_tpu_torch.storage.xl import XLStorage

    roots = [os.path.join(work, f"hsdisk{i}") for i in range(N)]
    ol = ErasureObjects([XLStorage(r) for r in roots], parity_blocks=M,
                        block_size=BLOCK, device=dev)
    srv = S3Server(ol, address="127.0.0.1:0").start()
    if srv.server_mode != "threaded":
        fail(f"heal_seq: server plane {srv.server_mode}")
    host, port = srv.host, srv.port
    rng = np.random.default_rng(SEED + 22)
    objs = {f"o{j:02d}": rng.bytes(S3_BIG) for j in range(HS_OBJECTS)}
    nbytes = sum(len(v) for v in objs.values())
    bkt = HS_BUCKET
    one = S3Signer(host, port)
    out: dict = {"objects": HS_OBJECTS, "bytes": nbytes,
                 "wiped_drives": list(HS_WIPED)}

    def admin(tail: str, query: dict, want: int = 200):
        st, _h, body = one.request("POST", f"{ADMIN}/{tail}", query)
        if st != want:
            fail(f"heal_seq: admin {tail} {query}: {st} {body[:300]!r}")
        return _json.loads(body) if st == 200 else _admin_error(body)

    def files() -> list:
        return [_drive_files(r, bkt) for r in roots]

    def poll(path_q: dict, token: str, until=("finished",)) -> "tuple":
        """Poll until the status leaves running; (last doc, every item)."""
        items = []
        deadline = time.monotonic() + 600
        while True:
            doc = admin("heal-sequence", {**path_q, "clientToken": token})
            items.extend(doc["items"])
            if doc["status"] != "running":
                break
            if time.monotonic() > deadline:
                fail(f"heal_seq: sequence still running after 600 s: {doc}")
            time.sleep(HS_POLL_S)
        if doc["status"] not in until:
            fail(f"heal_seq: sequence ended {doc['status']}: {doc}")
        return doc, items

    def object_items(items) -> list:
        return sorted(i.get("object", "") for i in items
                      if i["type"] == "object")

    try:
        st, _h, body = one.request("PUT", f"/{bkt}")
        if st != 200:
            fail(f"heal_seq: bucket create {st} {body[:200]!r}")
        kernels.reset_launches()
        keys = sorted(objs)

        def put(s, k):
            st, _h, body = s.request("PUT", f"/{bkt}/{k}", body=objs[k])
            if st != 200:
                fail(f"heal_seq: PUT {k}: {st} {body[:200]!r}")

        put_s, _ = _in_clients(host, port, [keys[c::S3_CLIENTS]
                                            for c in range(S3_CLIENTS)], put)
        out["put"] = {"s": put_s, "MBps": nbytes / put_s / 1e6,
                      "launches": _nonzero(kernels.LAUNCHES)}
        before = files()
        if any(len(f) != 2 * HS_OBJECTS for f in before):
            fail("heal_seq: a drive does not hold xl.meta and part.1 of "
                 "every object")
        for d in HS_WIPED:
            _wipe_payload(roots[d])

        # -- a dry run reports every object and writes nothing -------------
        t0 = time.monotonic()
        tok = admin("heal-sequence", {"bucket": bkt, "dryRun": "true"})[
            "client_token"]
        doc, items = poll({"bucket": bkt}, tok)
        dry_s = time.monotonic() - t0
        if (doc["scanned"], doc["healed"], doc["failed"]) != (HS_OBJECTS,
                                                             HS_OBJECTS, 0):
            fail(f"heal_seq: dry run counted {doc}")
        outdated = {i["object"]: i["outdated"] for i in items
                    if i["type"] == "object"}
        if sorted(outdated) != keys or any(len(v) != len(HS_WIPED)
                                           for v in outdated.values()):
            fail(f"heal_seq: dry run reported {outdated}")
        if any(os.listdir(roots[d]) != [".sys"] for d in HS_WIPED):
            fail("heal_seq: the dry run wrote onto a wiped drive")
        out["dry_run"] = {"s": dry_s, "reported": doc["healed"]}

        # -- the sequence, timed; the refusals while it runs -----------------
        kernels.reset_launches()
        t0 = time.monotonic()
        launch = admin("heal-sequence", {"bucket": bkt})
        tok = launch["client_token"]
        refusals = {
            "again": admin("heal-sequence", {"bucket": bkt}, 400),
            "overlap": admin("heal-sequence", {"bucket": bkt,
                                               "prefix": "o0"}, 400),
            "bad_token": admin("heal-sequence", {"bucket": bkt,
                                                 "clientToken": "0" * 32}, 400),
        }
        doc, items = poll({"bucket": bkt}, tok)
        seq_s = time.monotonic() - t0
        seq_launches = _nonzero(kernels.LAUNCHES)
        if refusals != {"again": "XMinioHealAlreadyRunning",
                        "overlap": "XMinioHealOverlappingPaths",
                        "bad_token": "XMinioHealInvalidClientToken"}:
            fail(f"heal_seq: refusals while running {refusals}")
        if (doc["scanned"], doc["healed"], doc["failed"]) != (HS_OBJECTS,
                                                             HS_OBJECTS, 0):
            fail(f"heal_seq: sequence counted {doc}")
        if [i["type"] for i in items].count("bucket") != 1 or \
                object_items(items) != keys:
            fail(f"heal_seq: popped items {[(i['type'], i.get('object')) for i in items]}")
        if any(i["healed"] != i["outdated"] or len(i["healed"]) != len(HS_WIPED)
               for i in items if i["type"] == "object"):
            fail("heal_seq: an item healed other shards than were lost")
        if files() != before:
            fail("heal_seq: part files or xl.meta differ from before the wipe")
        for name in ("verify_reconstruct_pipelined", "encode_pack[group=0]"):
            if seq_launches.get(name, 0) <= 0:
                fail(f"heal_seq: {name} never launched in the sequence")
        out["sequence"] = {
            "s": seq_s, "MBps": nbytes / seq_s / 1e6,
            "heal_object_MBps_this_run": heal_object_MBps,
            "scanned": doc["scanned"], "healed": doc["healed"],
            "items": len(items), "refusals": refusals,
            "launches": seq_launches}

        # -- stop in mid-walk, then forceStart heals the rest ----------------
        for d in HS_RESTART_WIPED:
            _wipe_payload(roots[d])
        tok = admin("heal-sequence", {"bucket": bkt})["client_token"]
        while True:
            doc = admin("heal-sequence", {"bucket": bkt, "clientToken": tok})
            if doc["scanned"] >= 2 or doc["status"] != "running":
                break
            time.sleep(0.05)
        stop = admin("heal-sequence/stop", {"bucket": bkt})
        doc, _items = poll({"bucket": bkt}, tok, until=("stopped",))
        first = doc["healed"]
        if stop["status"] != "stopping" or not 0 < first < HS_OBJECTS:
            fail(f"heal_seq: stop answered {stop}, then healed {first}")
        tok = admin("heal-sequence", {"bucket": bkt, "forceStart": "true"})[
            "client_token"]
        doc, _items = poll({"bucket": bkt}, tok)
        if doc["healed"] != HS_OBJECTS - first:
            fail(f"heal_seq: forceStart healed {doc['healed']} after the stop "
                 f"healed {first}")
        if files() != before:
            fail("heal_seq: files differ after the stopped and forced sequences")
        out["stop_force"] = {"stopped_after": first,
                             "force_start_healed": doc["healed"]}
    finally:
        one.close()
        srv.shutdown()
        for r in roots:
            shutil.rmtree(r, ignore_errors=True)
    return out


# -- phase 13: bucket federation (slice 9d) -----------------------------------

FED_DRIVES = "disk{1...12}"  # per server: one EC 8+4 set
FED_OBJECTS = 4  # of S3_BIG, PUT and read back through the redirect
FED_RACES = 4  # rounds of both servers creating one name at once
FED_RTT_REPS = 10  # cut from 20


def _read_head(f) -> "tuple[int, dict]":
    line = f.readline()
    parts = line.split(None, 2)
    if len(parts) < 2:
        raise OSError(f"bad status line {line!r}")
    headers = {}
    while True:
        h = f.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        k, _, v = h.decode("latin-1").partition(":")
        headers[k.strip().lower()] = v.strip()
    return int(parts[1]), headers


def put_expect(signer: "S3Signer", path: str, body: bytes,
               payload_hash: str) -> "tuple[int, dict, bytes]":
    """A signed PUT with ``Expect: 100-continue``, as S3 SDKs send one:
    the body follows only a 100 Continue, so a 307 to another server
    costs the headers alone.  (status, headers, body) of the final
    response, on a connection of its own."""
    import socket
    import urllib.parse

    headers = {"host": f"{signer.host}:{signer.port}",
               "x-amz-date": signer._now(),
               "x-amz-content-sha256": payload_hash}
    signer._sign("PUT", path, None, headers, payload_hash)
    headers["content-length"] = str(len(body))
    headers["expect"] = "100-continue"
    s = socket.create_connection((signer.host, signer.port), timeout=600)
    try:
        s.sendall((f"PUT {urllib.parse.quote(path)} HTTP/1.1\r\n" + "".join(
            f"{k}: {v}\r\n" for k, v in headers.items()) + "\r\n").encode())
        f = s.makefile("rb")
        status, hdrs = _read_head(f)
        if status == 100:
            s.sendall(body)
            status, hdrs = _read_head(f)
        n = int(hdrs.get("content-length") or 0)
        return status, hdrs, f.read(n) if n else b""
    finally:
        s.close()


def federation_phase(work: str, backend: "str | None" = None) -> dict:
    """Phase 13 (slice 9d): two ``python -m minio_tpu_torch.server
    --parity 4`` processes on the card, each over 12 drives of its own
    (one EC 8+4 set, 10 MiB blocks) on the async plane, sharing one
    MINIO_TPU_FEDERATION_DIR: the shared etcd of MinIO's bucket-lookup
    federation guide (docs/federation/lookup).  A bucket made on A is
    answered 307 to A by B; clients that follow the redirect (PUTs with
    Expect: 100-continue) write 4 x 64 MiB through B and read them back;
    both servers creating one name at once give one 200 and one
    BucketAlreadyExists; ListBuckets is the union on both; a DELETE
    frees the name for B.  ``backend`` sets MINIO_ERASURE_BACKEND for a
    rehearsal on the CPU."""
    import hashlib
    import json as _json
    import threading
    import urllib.parse

    import numpy as np

    fed_dir = os.path.join(work, "federation")
    env = {k: v for k, v in os.environ.items()
           if k not in ("MINIO_TPU_SERVER", "MINIO_ERASURE_BACKEND")}
    env["MINIO_TPU_LOG_LEVEL"] = "warning"
    env["MINIO_TPU_FEDERATION_DIR"] = fed_dir
    if backend is not None:
        env["MINIO_ERASURE_BACKEND"] = backend
    rng = np.random.default_rng(SEED + 23)
    objs = {f"big{j}": rng.bytes(S3_BIG) for j in range(FED_OBJECTS)}
    sha = {k: hashlib.sha256(v).hexdigest() for k, v in objs.items()}
    nbytes = sum(len(v) for v in objs.values())
    out: dict = {"servers": 2, "drives_each": N}
    servers: list = []

    def signer(i: int) -> S3Signer:
        return S3Signer("127.0.0.1", servers[i].port)

    def call(i: int, method: str, path: str, query=None):
        s = signer(i)
        try:
            return s.request(method, path, query)
        finally:
            s.close()

    def launches(i: int) -> dict:
        st, _h, body = call(i, "GET", f"{ADMIN}/kernel-stats")
        if st != 200:
            fail(f"federation: kernel-stats on server {i}: {st}")
        return _json.loads(body)["launches"]

    def follow(s: S3Signer, method: str, path: str, data: bytes = b""):
        """One request through ``s``, and to the Location of its 307."""
        if method == "PUT":
            st, h, body = put_expect(s, path, data, sha[path.rsplit("/", 1)[1]])
        else:
            st, h, body = s.request(method, path)
        if st != 307:
            fail(f"federation: {method} {path} on {s.port}: {st}, not 307")
        loc = urllib.parse.urlsplit(h["location"])
        owner = S3Signer(loc.hostname, loc.port)
        try:
            if method == "PUT":
                st, h, body = put_expect(owner, loc.path, data,
                                         sha[path.rsplit("/", 1)[1]])
            else:
                st, h, body = owner.request(method, loc.path)
        finally:
            owner.close()
        return st, body, f"{loc.hostname}:{loc.port}"

    def bucket_names(i: int) -> list:
        st, _h, body = call(i, "GET", "/")
        if st != 200:
            fail(f"federation: ListBuckets on server {i}: {st}")
        return _xml_text(body, "Name")

    t_phase = time.monotonic()
    try:
        for tag in ("a", "b"):
            servers.append(_BootedServer(
                work, _free_port(), env, f"fed-{tag}", what="federation",
                drives=os.path.join(work, f"fed-{tag}", FED_DRIVES)))
        out["spawn_to_ready_s"] = [srv.wait_ready() for srv in servers]
        a_ep = f"127.0.0.1:{servers[0].port}"
        for srv in servers:
            if "federation: bucket DNS at" not in srv.output():
                fail(f"federation: a server did not federate: {srv.output()[-1000:]}")

        # -- a bucket of A: B answers 307 to A -------------------------------
        st, _h, body = call(0, "PUT", "/fed-a")
        if st != 200:
            fail(f"federation: create on A {st} {body[:200]!r}")
        rtt = []
        s = signer(1)
        try:
            for _ in range(FED_RTT_REPS):
                t0 = time.monotonic()
                st, h, _b = s.request("GET", "/fed-a/big0")
                rtt.append((time.monotonic() - t0) * 1e3)
                if st != 307 or h.get("location") != f"http://{a_ep}/fed-a/big0":
                    fail(f"federation: B answered {st} {h.get('location')}")
        finally:
            s.close()
        out["redirect_ms"] = {"median": sorted(rtt)[len(rtt) // 2],
                              "min": min(rtt), "max": max(rtt)}
        la0, lb0 = launches(0), launches(1)
        keys = sorted(objs)
        b_port = servers[1].port
        put_s, owners = _in_clients("127.0.0.1", b_port, [[k] for k in keys],
                                    lambda s, k: follow(s, "PUT", f"/fed-a/{k}",
                                                        objs[k]))
        la1 = launches(0)
        if any(st != 200 or ep != a_ep for st, _b, ep in owners):
            fail(f"federation: PUTs through the redirect {[(st, ep) for st, _b, ep in owners]}")
        get_s, got = _in_clients("127.0.0.1", b_port, [[k] for k in keys],
                                 lambda s, k: follow(s, "GET", f"/fed-a/{k}"))
        la2, lb2 = launches(0), launches(1)
        for k, (st, body, ep) in zip(keys, got):
            if st != 200 or hashlib.sha256(body).hexdigest() != sha[k]:
                fail(f"federation: GET {k} through the redirect: {st}, differs")
        put_l = {k: la1[k] - la0.get(k, 0) for k in la1 if la1[k] != la0.get(k, 0)}
        get_l = {k: la2[k] - la1.get(k, 0) for k in la2 if la2[k] != la1.get(k, 0)}
        if not put_l.get("encode_pack_pipelined") or not get_l.get("phash256_batched"):
            fail(f"federation: K5/K2 did not launch on the owner: {put_l} {get_l}")
        if lb2 != lb0:
            fail("federation: the redirecting server launched kernels")
        out["put_through_redirect"] = {"bytes": nbytes, "s": put_s,
                                       "MBps": nbytes / put_s / 1e6,
                                       "owner_launches": put_l}
        out["get_through_redirect"] = {"bytes": nbytes, "s": get_s,
                                       "MBps": nbytes / get_s / 1e6,
                                       "owner_launches": get_l}

        # -- both create one name at once: one 200, one BucketAlreadyExists --
        races = []
        for r in range(FED_RACES):
            name = f"fed-race-{r}"
            res = [None, None]
            ts = [threading.Thread(target=lambda i=i, name=name: res.__setitem__(
                i, call(i, "PUT", f"/{name}"))) for i in (0, 1)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            codes = sorted((st, (_xml_text(b, "Code") if b else [""])[0])
                           for st, _h, b in res)
            if codes != [(200, ""), (409, "BucketAlreadyExists")]:
                fail(f"federation: racing creates of {name} gave {codes}")
            races.append(0 if res[0][0] == 200 else 1)
        out["race_winners"] = races

        # -- ListBuckets is the union on both --------------------------------
        st, _h, body = call(1, "PUT", "/fed-b")
        if st != 200:
            fail(f"federation: create on B {st}")
        want = sorted(["fed-a", "fed-b", *(f"fed-race-{r}" for r in range(FED_RACES))])
        lists = [bucket_names(i) for i in (0, 1)]
        if lists != [want, want]:
            fail(f"federation: ListBuckets {lists}, want {want}")

        # -- a DELETE unregisters; the name can then be made on B ------------
        for i, method, path, ok in ((0, "PUT", "/fed-gone", 200),
                                    (0, "DELETE", "/fed-gone", 204),
                                    (1, "PUT", "/fed-gone", 200)):
            st, _h, body = call(i, method, path)
            if st != ok:
                fail(f"federation: {method} {path} on server {i}: {st}")
        st, h, _b = call(0, "GET", "/fed-gone/k")
        if st != 307 or h.get("location") != f"http://127.0.0.1:{servers[1].port}/fed-gone/k":
            fail(f"federation: after the handover A answered {st} {h.get('location')}")
        with open(os.path.join(fed_dir, "fed-gone.json")) as f:
            out["handover_record"] = _json.load(f)
        out["sigterm_s"] = [srv.sigterm() for srv in servers]
    finally:
        for srv in servers:
            srv.kill()
    out["phase_s"] = time.monotonic() - t_phase
    return out


# -- the ListenBucketNotification stream, as a client reads it ----------------


class ListenStream:
    """A signed ``GET /<bucket>?events=...`` held open on a connection of
    its own; a thread collects the JSON records (whitespace keep-alives
    skipped) with the monotonic time each arrived, until ``close()``."""

    def __init__(self, host: str, port: int, bucket: str, query: dict):
        import hashlib
        import socket
        import threading
        import urllib.parse

        self.records: list = []  # (monotonic seconds, record)
        self.status = 0
        signer = S3Signer(host, port)
        signer.close()
        headers = {"host": f"{host}:{port}", "x-amz-date": signer._now(),
                   "x-amz-content-sha256": hashlib.sha256(b"").hexdigest()}
        signer._sign("GET", f"/{bucket}", query, headers,
                     headers["x-amz-content-sha256"])
        self._sock = socket.create_connection((host, port), timeout=600)
        self._sock.sendall((
            f"GET /{bucket}?{urllib.parse.urlencode(query)} HTTP/1.1\r\n"
            + "".join(f"{k}: {v}\r\n" for k, v in headers.items())
            + "\r\n").encode())
        self._opened = threading.Event()
        self._thread = threading.Thread(target=self._read, daemon=True,
                                        name="listen-stream")
        self._thread.start()
        if not self._opened.wait(60) or self.status != 200:
            self.close()
            fail(f"listen stream on {port}/{bucket}: HTTP {self.status}")

    def _read(self) -> None:
        f = self._sock.makefile("rb")
        try:
            self.status, _h = _read_head(f)
            self._opened.set()
            while True:
                line = f.readline()
                if not line:
                    return
                line = line.strip()
                if line.startswith(b"{"):
                    self.records.append((time.monotonic(), json.loads(line)))
        except (OSError, ValueError):
            return
        finally:
            self._opened.set()

    def keys(self) -> list:
        return [rec["Key"] for _t, rec in self.records]

    def close(self) -> None:
        import socket

        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        self._thread.join(timeout=10)


class _WebhookSink:
    """A loopback webhook endpoint (stdlib http.server): each POSTed
    event record with the monotonic time it arrived.  ``stop()`` and
    ``start()`` take it down and bring it back on the same port."""

    def __init__(self):
        self.records: list = []
        self.port = _free_port()
        self._srv = None
        self.start()

    def start(self) -> None:
        import http.server
        import threading

        sink = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                sink.records.append((time.monotonic(), json.loads(body)))
                # one record a connection: a stopped sink holds no open
                # connection that would still take records
                self.close_connection = True
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.send_header("Connection", "close")
                self.end_headers()

        self._srv = http.server.ThreadingHTTPServer(("127.0.0.1", self.port),
                                                    Handler)
        self._srv.daemon_threads = True
        threading.Thread(target=self._srv.serve_forever, daemon=True,
                         name="webhook-sink").start()

    def stop(self) -> None:
        if self._srv is not None:
            self._srv.shutdown()
            self._srv.server_close()
            self._srv = None


# -- phase 13b: bucket replication, events and the disk cache (slice 9c) ------

REPL_DRIVES = "disk{1...12}"  # per server: one EC 8+4 set
# of S3_BIG, PUT by 4 clients into the source bucket: 8 took the script to
# 1,089.7 s of command on an H100 machine, past the 900 s it keeps to
REPL_OBJECTS = 4
REPL_PARKED = 2  # PUT while the webhook sink is down: parked in the queue
REPL_FAILED = 2  # PUT while the target server is down: FAILED, caught up
# the parked, FAILED and overwriting objects' size: their checks ask for
# their records, status and bodies, not their bandwidth
REPL_SMALL = S3_BIG // 16
REPL_CACHE_QUOTA_MB = 1024  # per cache drive: 16 x S3_BIG
REPL_POLL_S = 0.05
REPL_WAIT_S = 120.0
REPL_SRC, REPL_DST = "src", "dst"
REPL_WEBHOOK_ARN = "arn:minio:sqs::1:webhook"


def replication_phase(work: str, backend: "str | None" = None) -> dict:
    """Phase 13b (slice 9c): two ``python -m minio_tpu_torch.server
    --parity 4`` processes on the card, A and B, each over 12 drives of
    its own (one EC 8+4 set, 10 MiB blocks) on the async plane: MinIO's
    bucket-replication guide (docs/bucket/replication: a versioned
    source and target, ``mc admin bucket remote add``, one replication
    rule).  A also fronts its object layer with the disk cache (two
    cache drives, ``MINIO_TPU_CACHE_QUOTA_MB`` each) and sends bucket
    events to a webhook in this script (a loopback sink) through a
    queue directory.

    4 SigV4 clients PUT 4 x 64 MiB into A's ``src``; HEAD on A reads
    each object's ``x-amz-replication-status`` until COMPLETED; B's
    ``dst`` holds each one (sha256), the first one's part files and
    xl.meta equal to the port's plain CPU codec writing the same bytes.
    The webhook and a ListenBucketNotification stream each carry the 4
    ObjectCreated:Put records; with the sink down 2 more PUTs park their
    records in the queue directory, delivered in order once it is back.
    With B down 2 PUTs read FAILED; B restarted and an admin crawl on A
    bring them to COMPLETED.  Two passes of GETs through the disk cache:
    misses (K2 launches rise) then hits (K2 launches stay); an overwrite
    misses with the new body; a cached range equals the backend's.
    ``backend`` sets MINIO_ERASURE_BACKEND for a rehearsal on the CPU."""
    import hashlib
    import statistics

    import numpy as np

    from minio_tpu_torch.codec.erasure import BLOCK_SIZE_V1
    from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
    from minio_tpu_torch.storage.xl import XLStorage

    base = os.path.join(work, "repl")
    os.makedirs(base, exist_ok=True)
    sink = _WebhookSink()
    qdir = os.path.join(base, "queue")
    cache_dirs = [os.path.join(base, f"cache{i}") for i in range(2)]
    env = {k: v for k, v in os.environ.items()
           if k not in ("MINIO_TPU_SERVER", "MINIO_ERASURE_BACKEND")
           and not k.startswith(("MINIO_TPU_READ_CACHE", "MINIO_TPU_FEDERATION",
                                 "MINIO_TPU_NOTIFY_", "MINIO_TPU_CACHE_"))}
    env["MINIO_TPU_LOG_LEVEL"] = "warning"
    # the catch-up pass runs when this phase asks (admin crawl), not on
    # a timer that could re-queue a FAILED version first
    env["MINIO_TPU_CRAWL_INTERVAL_S"] = "3600"
    if backend is not None:
        env["MINIO_ERASURE_BACKEND"] = backend
    env_a = dict(env)
    env_a.update({
        "MINIO_TPU_CACHE_DRIVES": ",".join(cache_dirs),
        "MINIO_TPU_CACHE_QUOTA_MB": str(REPL_CACHE_QUOTA_MB),
        "MINIO_TPU_NOTIFY_WEBHOOK_ENABLE_1": "on",
        "MINIO_TPU_NOTIFY_WEBHOOK_ENDPOINT_1":
            f"http://127.0.0.1:{sink.port}/minio/events",
        "MINIO_TPU_NOTIFY_WEBHOOK_QUEUE_DIR_1": qdir,
    })
    rng = np.random.default_rng(SEED + 31)
    keys = [f"big{j}" for j in range(REPL_OBJECTS)]
    objs = {k: rng.bytes(S3_BIG) for k in keys}
    sha = {k: hashlib.sha256(v).hexdigest() for k, v in objs.items()}
    nbytes = sum(len(v) for v in objs.values())
    out: dict = {"servers": 2, "drives_each": N, "objects": REPL_OBJECTS,
                 "object_bytes": S3_BIG}
    servers: list = []
    ports = [_free_port(), _free_port()]
    drives = [os.path.join(base, tag, REPL_DRIVES) for tag in ("a", "b")]

    def call(i: int, method: str, path: str, query=None, body=b"",
             headers=None):
        s = S3Signer("127.0.0.1", ports[i])
        try:
            return s.request(method, path, query, body=body, headers=headers)
        finally:
            s.close()

    def ok(i, what, method, path, query=None, body=b"", want=200):
        st, h, b = call(i, method, path, query, body)
        if st != want:
            fail(f"replication: {what} on {'AB'[i]}: {st} {b[:300]!r}")
        return h, b

    def admin(i: int, method: str, tail: str, query=None, body=b"") -> dict:
        _h, b = ok(i, f"admin {tail}", method, f"{ADMIN}/{tail}", query, body)
        return json.loads(b) if b else {}

    def launches(i: int) -> dict:
        return admin(i, "GET", "kernel-stats")["launches"]

    def delta(a: dict, b: dict) -> dict:
        return {k: b[k] - a.get(k, 0) for k in b if b[k] != a.get(k, 0)}

    def status(s: S3Signer, key: str) -> str:
        st, h, _b = s.request("HEAD", f"/{REPL_SRC}/{key}")
        if st != 200:
            fail(f"replication: HEAD {key} on A: {st}")
        return h.get("x-amz-replication-status", "")

    def await_status(want: str, names: list, since: float) -> dict:
        """Seconds from ``since`` until each key's HEAD reads ``want``."""
        got: dict = {}
        s = S3Signer("127.0.0.1", ports[0])
        try:
            while len(got) < len(names):
                if time.monotonic() - since > REPL_WAIT_S:
                    fail(f"replication: {sorted(set(names) - set(got))} never "
                         f"read {want}; A: {servers[0].output()[-1500:]}")
                for k in names:
                    if k not in got and status(s, k) == want:
                        got[k] = time.monotonic()
                time.sleep(REPL_POLL_S)
        finally:
            s.close()
        return got

    def check_on_b(names: list, bodies: dict) -> None:
        for k in names:
            st, _h, b = call(1, "GET", f"/{REPL_DST}/{k}")
            if st != 200 or hashlib.sha256(b).hexdigest() != \
                    hashlib.sha256(bodies[k]).hexdigest():
                fail(f"replication: {k} on B: {st}, differs from the source")

    def put(s: S3Signer, key: str, data: bytes):
        st, h, b = s.request("PUT", f"/{REPL_SRC}/{key}", body=data,
                             payload_hash=hashlib.sha256(data).hexdigest())
        if st != 200:
            fail(f"replication: PUT {key}: {st} {b[:300]!r}")
        return key, time.monotonic(), h["etag"].strip('"')

    def queue_files() -> list:
        try:
            return sorted(n for n in os.listdir(qdir) if n.endswith(".json"))
        except FileNotFoundError:
            return []

    t_phase = time.monotonic()
    stream = None
    try:
        # -- 1. both servers at once; buckets, target, rule, events ---------
        for i, tag in enumerate(("a", "b")):
            servers.append(_BootedServer(
                work, ports[i], env_a if i == 0 else env, f"repl-{tag}",
                what="replication", drives=drives[i]))
        out["spawn_to_ready_s"] = [srv.wait_ready() for srv in servers]
        if "disk cache enabled" not in servers[0].output():
            fail(f"replication: A has no disk cache: {servers[0].output()[-1000:]}")
        versioning = (b"<VersioningConfiguration><Status>Enabled</Status>"
                      b"</VersioningConfiguration>")
        for i, b in ((0, REPL_SRC), (1, REPL_DST)):
            ok(i, f"create {b}", "PUT", f"/{b}")
            ok(i, f"versioning {b}", "PUT", f"/{b}", {"versioning": ""},
               versioning)
        arn = admin(0, "PUT", "set-remote-target", {"bucket": REPL_SRC},
                    json.dumps({"endpoint": f"http://127.0.0.1:{ports[1]}",
                                "access_key": "minioadmin",
                                "secret_key": "minioadmin",
                                "target_bucket": REPL_DST}).encode())["arn"]
        ok(0, "replication rule", "PUT", f"/{REPL_SRC}", {"replication": ""},
           ("<ReplicationConfiguration><Rule><ID>all</ID><Status>Enabled"
            "</Status><Priority>1</Priority><Filter><Prefix></Prefix>"
            f"</Filter><Destination><Bucket>{arn}</Bucket></Destination>"
            "</Rule></ReplicationConfiguration>").encode())
        ok(0, "notification", "PUT", f"/{REPL_SRC}", {"notification": ""},
           ("<NotificationConfiguration><QueueConfiguration><Id>hook</Id>"
            f"<Queue>{REPL_WEBHOOK_ARN}</Queue>"
            "<Event>s3:ObjectCreated:*</Event><Event>s3:ObjectRemoved:*</Event>"
            "</QueueConfiguration></NotificationConfiguration>").encode())
        stream = ListenStream("127.0.0.1", ports[0], REPL_SRC,
                              {"events": "s3:ObjectCreated:*"})

        # -- 2. 4 clients PUT; each object replicated to COMPLETED ----------
        la0, lb0 = launches(0), launches(1)
        t_put = time.monotonic()
        put_s, acks = _in_clients("127.0.0.1", ports[0],
                                  [keys[c::S3_CLIENTS] for c in range(S3_CLIENTS)],
                                  lambda s, k: put(s, k, objs[k]))
        ack = {k: t for k, t, _e in acks}
        etag = {k: e for k, _t, e in acks}
        la1 = launches(0)
        done = await_status("COMPLETED", keys, t_put)
        t_done = max(done.values())
        la2, lb2 = launches(0), launches(1)
        check_on_b(keys, objs)
        lag = sorted(done[k] - ack[k] for k in keys)
        out["put"] = {"bytes": nbytes, "s": put_s, "MBps": nbytes / put_s / 1e6,
                      "launches_A": delta(la0, la1)}
        out["replicated"] = {
            "bytes": nbytes, "s": t_done - t_put,
            "MBps": nbytes / (t_done - t_put) / 1e6,
            "lag_s": {"median": statistics.median(lag), "min": lag[0],
                      "max": lag[-1]},
            "launches_A_reads": delta(la1, la2),
            "launches_B_puts": delta(lb0, lb2),
            "equal_on_B": len(keys)}
        if not out["put"]["launches_A"].get("encode_pack_pipelined"):
            fail(f"replication: K5 did not launch on A's PUTs: {out['put']}")
        if not out["replicated"]["launches_B_puts"].get("encode_pack_pipelined"):
            fail(f"replication: K5 did not launch on B's replicated PUTs: "
                 f"{out['replicated']}")
        if not out["replicated"]["launches_A_reads"].get("phash256_batched"):
            fail(f"replication: K2 did not launch on A's replication reads: "
                 f"{out['replicated']}")
        # the first object on B's drives against the plain CPU codec
        ref_roots = [os.path.join(base, "ref", f"d{j}") for j in range(N)]
        ref = ErasureObjects([XLStorage(r) for r in ref_roots],
                             parity_blocks=M, block_size=BLOCK_SIZE_V1,
                             device="cpu")
        ref.make_bucket(REPL_DST)
        ref.put_object(REPL_DST, keys[0], io.BytesIO(objs[keys[0]]), S3_BIG)
        b_roots = [os.path.join(base, "b", f"disk{j + 1}") for j in range(N)]
        for j, (r, c) in enumerate(zip(ref_roots, b_roots)):
            if _obj_state(c, keys[0], REPL_DST) != _obj_state(r, keys[0], REPL_DST):
                fail(f"replication: {keys[0]} on B's drive {j + 1} differs "
                     "from the plain codec's")
        out["held_drives"] = N

        # -- 3. the webhook and the listen stream; records parked, replayed -
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and (
                len(sink.records) < len(keys) or len(stream.records) < len(keys)):
            time.sleep(REPL_POLL_S)
        hook = {rec["Key"]: (t, rec) for t, rec in sink.records}
        want = {f"{REPL_SRC}/{k}" for k in keys}
        if set(hook) != want or any(
                rec["EventName"] != "s3:ObjectCreated:Put" for _t, rec in hook.values()):
            fail(f"replication: webhook records {sorted(hook)}")
        for k in keys:
            obj = hook[f"{REPL_SRC}/{k}"][1]["Records"][0]["s3"]["object"]
            if (obj["key"], obj["size"], obj["eTag"]) != (k, S3_BIG, etag[k]):
                fail(f"replication: webhook record of {k}: {obj}")
        if sorted(stream.keys()) != sorted(want):
            fail(f"replication: listen stream {stream.keys()}")
        delay = sorted(hook[f"{REPL_SRC}/{k}"][0] - ack[k] for k in keys)
        ldelay = sorted(t - ack[rec["Key"].split("/", 1)[1]]
                        for t, rec in stream.records)
        out["webhook"] = {"records": len(hook), "delay_s": {
            "median": statistics.median(delay), "min": delay[0], "max": delay[-1]}}
        out["listen"] = {"records": len(stream.records), "delay_s": {
            "median": statistics.median(ldelay), "min": ldelay[0],
            "max": ldelay[-1]}}
        sink.stop()
        parked = {f"parked{j}": rng.bytes(REPL_SMALL) for j in range(REPL_PARKED)}
        s = S3Signer("127.0.0.1", ports[0])
        try:
            for k, v in parked.items():  # in order, one client
                put(s, k, v)
        finally:
            s.close()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and len(queue_files()) < REPL_PARKED:
            time.sleep(REPL_POLL_S)
        files = queue_files()
        if len(files) != REPL_PARKED:
            fail(f"replication: queue directory holds {files}")
        n_before = len(sink.records)
        t_up = time.monotonic()
        sink.start()
        # the queue store retries every 5 s: two intervals at most
        while time.monotonic() - t_up < 10.0 and (
                queue_files() or len(sink.records) < n_before + REPL_PARKED):
            time.sleep(REPL_POLL_S)
        replayed = [rec["Key"] for _t, rec in sink.records[n_before:]]
        if replayed != [f"{REPL_SRC}/{k}" for k in parked] or queue_files():
            fail(f"replication: parked records replayed {replayed}, "
                 f"queue {queue_files()}")
        out["parked"] = {"files": len(files), "replayed": replayed,
                         "replay_s": max(t for t, _r in sink.records[n_before:]) - t_up}
        await_status("COMPLETED", list(parked), time.monotonic())

        # -- 4. B down: FAILED; B back and an admin crawl: COMPLETED --------
        lb_term = launches(1)
        out["sigterm_B_s"] = servers[1].sigterm()
        servers[1].kill()  # closes its log
        failed = {f"late{j}": rng.bytes(REPL_SMALL) for j in range(REPL_FAILED)}
        t_f = time.monotonic()
        s = S3Signer("127.0.0.1", ports[0])
        try:
            for k, v in failed.items():
                put(s, k, v)
        finally:
            s.close()
        await_status("FAILED", list(failed), t_f)
        servers[1] = _BootedServer(work, ports[1], env, "repl-b2",
                                   what="replication", drives=drives[1])
        out["restart_B_s"] = servers[1].wait_ready()
        t_c = time.monotonic()
        crawl = admin(0, "POST", "crawl")
        caught = await_status("COMPLETED", list(failed), t_c)
        check_on_b(list(failed), failed)
        out["catch_up"] = {"failed": len(failed), "s": max(caught.values()) - t_c,
                           "crawled_objects": crawl["buckets"][REPL_SRC]["objects"],
                           "launches_B_restarted": {
                               k: v for k, v in launches(1).items() if v}}
        if not out["catch_up"]["launches_B_restarted"].get("encode_pack_pipelined"):
            fail(f"replication: K5 did not launch on the restarted B: "
                 f"{out['catch_up']}")

        # -- 5. the disk cache: a miss pass, a hit pass ----------------------
        def get(s, k):
            st, _h, b = s.request("GET", f"/{REPL_SRC}/{k}")
            if st != 200 or hashlib.sha256(b).hexdigest() != sha[k]:
                fail(f"replication: GET {k} through the disk cache: {st}")
            return len(b)

        passes = []
        for name in ("miss", "hit"):
            c0, l0 = admin(0, "GET", "cache-stats"), launches(0)
            wall, _n = _in_clients("127.0.0.1", ports[0],
                                   [keys[c::S3_CLIENTS] for c in range(S3_CLIENTS)],
                                   get)
            c1, l1 = admin(0, "GET", "cache-stats"), launches(0)
            passes.append({"pass": name, "s": wall, "MBps": nbytes / wall / 1e6,
                           "hits": c1["hits"] - c0["hits"],
                           "misses": c1["misses"] - c0["misses"],
                           "launches": delta(l0, l1)})
        # the bucket's metadata document (.sys) is read through the disk
        # cache too, whenever its TTL lapses: a hit or two beside the objects
        miss, hit = passes
        if miss["misses"] != len(keys) or not miss["launches"].get("phash256_batched"):
            fail(f"replication: the first GET pass {miss}")
        if hit["hits"] < len(keys) or hit["misses"] or hit["launches"]:
            fail(f"replication: the second GET pass {hit}")
        new_body = rng.bytes(REPL_SMALL)
        sg = S3Signer("127.0.0.1", ports[0])
        try:
            put(sg, keys[0], new_body)
            c0 = admin(0, "GET", "cache-stats")
            st, _h, b = sg.request("GET", f"/{REPL_SRC}/{keys[0]}")
            c1 = admin(0, "GET", "cache-stats")
            if st != 200 or b != new_body or c1["misses"] - c0["misses"] != 1:
                fail("replication: the overwritten object's GET was not a "
                     "miss with the new body")
            lo, hi = S3_BIG // 3, S3_BIG // 3 + 5 * (1 << 20) + 7
            rng_hdr = {"range": f"bytes={lo}-{hi}"}
            st, _h, cached = sg.request("GET", f"/{REPL_SRC}/{keys[1]}",
                                            headers=rng_hdr)
            vid = ok(0, "HEAD", "HEAD", f"/{REPL_SRC}/{keys[1]}")[0][
                "x-amz-version-id"]
            # a GET naming the version bypasses the cache: the backend's
            st2, _h, backend_rng = sg.request(
                "GET", f"/{REPL_SRC}/{keys[1]}", {"versionId": vid},
                headers=rng_hdr)
            if st != 206 or st2 != 206 or cached != backend_rng or \
                    cached != objs[keys[1]][lo:hi + 1]:
                fail(f"replication: a cached range {st} differs from the "
                     f"backend's {st2}")
        finally:
            sg.close()
        stats = admin(0, "GET", "cache-stats")
        out["cache"] = {"passes": passes, "overwrite_miss": True,
                        "range_equal": True, "stats": stats}
        stream.close()
        stream = None
        out["launches_A"] = delta(la0, launches(0))
        out["launches_B"] = delta(lb0, lb_term)  # before its restart
        out["sigterm_s"] = [srv.sigterm() for srv in servers]
    finally:
        if stream is not None:
            stream.close()
        for srv in servers:
            srv.kill()
        sink.stop()
        shutil.rmtree(base, ignore_errors=True)
    out["phase_s"] = time.monotonic() - t_phase
    return out


# -- phase 14: the chaos grid (slice 9d) --------------------------------------

# the ten cells of the grid, in the order they run; when the script must
# be cut, cells go from the end of this list.  ``replication_lag_churn``
# comes before ``select_heavy_mix`` as in the JAX grid's order, and takes
# the place of ``hot_key_cache_flood``, whose device-tier hot-key traffic
# the read_cache phase drives
GRID_ORDER = ("heal_storm", "dead_remote_disks", "replication_lag_churn",
              "select_heavy_mix", "hot_key_cache_flood", "partition_mid_put",
              "rolling_restart", "wedged_loop", "slow_remote_disks",
              "hot_key_flood")
# the cells this script runs: with nine it took 874.4-993.8 s of command
# on the H100 machines, with five 953.9 s; these four, beside the
# replication phase, after the depth cuts of BC_SMALL, HS_OBJECTS and
# CLUSTER_RAW_ROUNDS
GRID_RUN = GRID_ORDER[:4]


GET_STAGES = ("queue", "lock", "meta", "open", "shard_reads", "verify",
              "assemble", "write", "unlock")


def thread_cpu_moved(before: list, after: list, wall: float) -> dict:
    """A node's CPU over a window from two ``request-stages`` thread
    lists: the cores it kept busy and its 6 busiest thread families
    (names less their trailing numbers), cores each."""
    was = {t["tid"]: t["cpu_s"] for t in before}
    fam: dict = {}
    total = 0.0
    for t in after:
        d = t["cpu_s"] - was.get(t["tid"], 0.0)
        total += d
        name = re.sub(r"[-_ ]?\d+$", "", t["name"])
        fam[name] = fam.get(name, 0.0) + d
    top = sorted(fam.items(), key=lambda kv: -kv[1])[:6]
    return {"cores": total / wall, "top": {k: v / wall for k, v in top}}


def get_stages(seen: list, records: list) -> dict:
    """Stage breakdown of a timed GET flood: ``seen`` holds the client's
    (node, seconds, request id) of each GET, ``records`` the nodes'
    request-stage spans.  For the 5 slowest GETs and the median one: the
    client's ms, the serving node's handler ms and each stage's ms
    (``other``: the handler's own work; ``outside``: the client's time
    outside the handler up to its release, i.e. connect, accept, the
    head's parse and the reply's way back).  Beside them, the internode requests the nodes
    served during the flood, by plane: count, mean and max of their
    queue wait and handler ms."""
    by_id = {r.get("request_id"): r for r in records if r.get("request_id")}

    def row(node, secs, rid):
        out = {"client_ms": secs * 1e3, "node": node + 1}
        r = by_id.get(rid)
        if r is None:
            return dict(out, joined=False)
        st = r.get("stages", {})
        out["handler_ms"] = r["total"] * 1e3
        for k in GET_STAGES:
            out[k] = st.get(k, 0.0) * 1e3
        out["other"] = out["handler_ms"] - sum(
            out[k] for k in GET_STAGES if k != "queue")
        # the release runs after the body went out
        out["outside"] = (out["client_ms"] - out["queue"]
                          - (out["handler_ms"] - out["unlock"]))
        return out

    ranked = sorted(seen, key=lambda x: x[1])
    internode: dict = {}
    for r in records:
        path = r.get("path", "")
        if not path.startswith("/minio-tpu/") or "/admin/" in path:
            continue
        plane = path.split("/")[2]
        d = internode.setdefault(plane, {"n": 0, "queue_ms": [], "handler_ms": []})
        d["n"] += 1
        d["queue_ms"].append(r.get("stages", {}).get("queue", 0.0) * 1e3)
        d["handler_ms"].append(r["total"] * 1e3)
    for d in internode.values():
        for k in ("queue_ms", "handler_ms"):
            v = d.pop(k)
            d[k] = {"mean": sum(v) / len(v), "max": max(v)}
    return {
        "gets": len(seen),
        "slowest": [row(*x) for x in ranked[::-1][:5]],
        "median": row(*ranked[len(ranked) // 2]) if ranked else None,
        "internode": internode,
    }


def grid_phase(work: str, backend: "str | None" = None) -> dict:
    """Phase 14 (slice 9d): the chaos grid of minio_tpu_torch.testgrid on
    the card, the cells of ``GRID_RUN``.  Each cell is a loopback cluster
    of 3 ``python -m minio_tpu_torch.server`` nodes x 2 drives (one
    6-drive set, EC 3+3) started by the port's ClusterHarness, its codec
    on the card (the default backend; ``backend`` sets
    MINIO_ERASURE_BACKEND for a rehearsal on the CPU), driven through its
    steps with faults delivered over the admin fault endpoint, then the
    JAX grid's invariant sweep: every object bit-identical at quorum on
    every live node or cleanly absent, no torn xl.meta, breaker trip and
    recovery where the cell waits for them.  Before each cluster stops,
    each live node's kernel launches are read from its admin kernel-stats
    (a restarted node counts from its restart).  ``replication_lag_churn``
    replicates inside each cluster: its destination must converge."""
    import json as _json

    from minio_tpu_torch.testgrid import engine, scenario_by_name

    env = {"MINIO_TPU_LOG_LEVEL": "warning"}
    if backend is not None:
        env["MINIO_ERASURE_BACKEND"] = backend
    node_launches: dict = {}

    class _Counted(engine.ClusterHarness):
        """The engine's harness, reading each live node's launches
        before it stops the cluster (this script's instrumentation)."""

        def stop(self):
            got = {}
            for n in self.nodes:
                if n.alive():
                    st, doc = self.admin(n.index, "GET", "kernel-stats")
                    if st == 200:
                        got[f"n{n.index + 1}"] = {
                            k: v for k, v in doc["launches"].items() if v}
            node_launches[self.base.name] = got
            super().stop()

    # the engine's p99 check, its two marks (ms) kept for the cell's line
    marks: dict = {}
    assert_p99 = engine._VERBS["assert_p99_within"]

    def _kept_p99(ctx, mark, baseline, *args):
        marks.update({k: ctx.marks[k] * 1e3 for k in (mark, baseline)})
        return assert_p99(ctx, mark, baseline, *args)

    # each timed GET flood's stage breakdown (GET_STAGES): the client's
    # latency of every GET joined by request id to the serving node's
    # stage spans (admin request-stages, minio_tpu_torch/utils/spans.py)
    timed_flood = engine._VERBS["timed_get_flood"]
    get_once = engine._get
    breakdowns: dict = {}

    def _staged_flood(ctx, key, count, threads, mark):
        cpu0 = {}
        for n in ctx.h.nodes:
            if n.alive():
                st, doc = ctx.h.admin(n.index, "GET", "request-stages")
                cpu0[n.index] = doc.get("threads", []) if st == 200 else []
        self0, t0 = time.process_time(), time.monotonic()
        seen: list = []

        def _get(c, node, k):
            t0 = time.monotonic()
            res = get_once(c, node, k)
            seen.append((node, time.monotonic() - t0,
                         res[1].get("x-amz-request-id", "")))
            return res

        engine._get = _get
        try:
            timed_flood(ctx, key, count, threads, mark)
        finally:
            engine._get = get_once
        wall = time.monotonic() - t0
        self1 = time.process_time()
        records, cpu = [], {}
        for n in ctx.h.nodes:
            if n.alive():
                st, doc = ctx.h.admin(n.index, "GET", "request-stages")
                if st == 200:
                    records += [dict(r, node=n.index)
                                for r in doc.get("records", [])]
                    cpu[f"n{n.index + 1}"] = thread_cpu_moved(
                        cpu0.get(n.index, []), doc.get("threads", []), wall)
        breakdowns[mark] = get_stages(seen, records)
        breakdowns[mark]["cpu"] = {
            "wall_s": wall, "client_cores": (self1 - self0) / wall, **cpu}

    harness = engine.ClusterHarness
    engine.ClusterHarness = _Counted
    engine._VERBS["assert_p99_within"] = _kept_p99
    engine._VERBS["timed_get_flood"] = _staged_flood
    out: dict = {"cells": {}}
    t_phase = time.monotonic()
    try:
        for name in GRID_RUN:
            sc = scenario_by_name(name)
            base = os.path.join(work, "grid", name)
            t0 = time.monotonic()
            marks.clear()
            breakdowns.clear()
            try:
                report = engine.run_scenario(sc, base, env=env)
            except AssertionError as e:
                print(f"grid {name} failed: " + _json.dumps(
                    {"p99_ms": marks, "get_stages": breakdowns}), flush=True)
                fail(f"grid: {name}: {e}")
            took = time.monotonic() - t0
            launches = node_launches.get(name, {})
            if report["objects"] < sc.seed_objects or report["meta_files"] <= 0:
                fail(f"grid: {name} report {report}")
            if any(s[0] == "await_breaker" for s in sc.steps) and \
                    not report["breaker_events"]:
                fail(f"grid: {name}: breaker cycle not observed")
            total: dict = {}
            for per in launches.values():
                for k, v in per.items():
                    total[k] = total.get(k, 0) + v
            want = ["encode_pack_pipelined", "phash256_batched"]
            if name == "heal_storm":
                want += ["verify_reconstruct_pipelined", "encode_pack[group=0]"]
            if name == "select_heavy_mix":
                want += ["select_screen"]
            missing = [k for k in want if not total.get(k)]
            if backend is None and missing:
                fail(f"grid: {name}: {missing} never launched; {launches}")
            out["cells"][name] = {"s": took, **report, "launches": launches}
            if marks:
                out["cells"][name]["p99_ms"] = dict(marks)
            if breakdowns:
                out["cells"][name]["get_stages"] = dict(breakdowns)
            print(f"grid {name}: {_json.dumps(out['cells'][name])}", flush=True)
    finally:
        engine.ClusterHarness = harness
        engine._VERBS["assert_p99_within"] = assert_p99
        engine._VERBS["timed_get_flood"] = timed_flood
        shutil.rmtree(os.path.join(work, "grid"), ignore_errors=True)
    out["phase_s"] = time.monotonic() - t_phase
    return out


# -- phase 15 (slice 9c): the backends without a codec ------------------------

BK_OBJECTS = 4  # objects of S3_BIG, PUT and GET by S3_CLIENTS clients a server
BK_MP_PARTS = 4  # parts of MP_PART in the FS server's multipart upload
BK_SELECT = 64 << 20  # the lineitem object Select Q1 scans (cut from 256 MiB)
BK_UPSTREAM = "disk{1...12}"  # the S3 gateway's upstream U: one EC 8+4 set
BK_SSEC_KEY = b"K" * 32


def backends_phase(dev, work: str, backend: "str | None" = None) -> dict:
    """Phase 15 (slice 9c): the port's servers over layers without a
    codec, as users start them (MinIO's standalone single-drive mode and
    its ``gateway nas`` and ``gateway s3`` guides), each a process of its
    own on the card (``backend`` sets MINIO_ERASURE_BACKEND for a rehearsal
    on the CPU).

    - **FS**: ``python -m minio_tpu_torch.server <dir>`` (spawned beside U).
      S3_CLIENTS clients PUT and GET BK_OBJECTS x S3_BIG; each object's
      file under ``<dir>/<bucket>/<key>`` has the body's sha256; one
      multipart upload of BK_MP_PARTS x MP_PART, a copy and a delimiter
      listing; Select Q1 over a BK_SELECT lineitem object, twice (the
      first starts the process's CUDA context), answers the host
      engine's Records; the server's kernel-stats show K8-K10 launches
      and no K5 or K2.
    - **NAS gateway**: ``server gateway nas <dir>`` over the same directory
      once the FS server stopped: it lists and reads what that wrote.
    - **S3 gateway**: ``server gateway s3 https://U`` on TLS, U an erasure
      server of 12 drives (EC 8+4) on TLS.  S3_CLIENTS clients PUT and GET
      BK_OBJECTS x S3_BIG through the gateway; U's part files and xl.meta
      of the first equal the plain CPU codec's; U's K5 and K2 launches
      rise and the gateway's stay 0; one SSE-C object goes PUT, GET and a
      copy through the gateway, and U holds both sealed with the
      client's key (a GET on U needs it); Select Q1 on an object held in
      U scans on the gateway's card."""
    import hashlib
    import io
    import json as _json

    import numpy as np

    from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
    from minio_tpu_torch.s3select.engine import S3Select, SelectRequest
    from minio_tpu_torch.storage.xl import XLStorage

    base = os.path.join(work, "bk")
    fs_dir = os.path.join(base, "fs")
    os.makedirs(base)
    cert, key = tls_cert(base)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("MINIO_TPU_") and k != "MINIO_ERASURE_BACKEND"}
    env["MINIO_TPU_LOG_LEVEL"] = "warning"
    if backend is not None:
        env["MINIO_ERASURE_BACKEND"] = backend
    tls_env = dict(env, MINIO_TPU_TLS="on", MINIO_TPU_CERT_FILE=cert,
                   MINIO_TPU_KEY_FILE=key)
    rng = np.random.default_rng(SEED + 15)
    objs = {f"big{i}": rng.integers(0, 256, S3_BIG, dtype=np.uint8).tobytes()
            for i in range(BK_OBJECTS)}
    sha = {k: hashlib.sha256(v).hexdigest() for k, v in objs.items()}
    nbytes = sum(len(v) for v in objs.values())
    lineitem = lineitem_csv(SEED + 15, BK_SELECT)
    q1 = select_body(SELECT_QUERIES["Q1"])
    # the host engine's answer, in this process
    os.environ["MINIO_TPU_SELECT"] = "host"
    try:
        frames: list = []
        S3Select(SelectRequest.from_xml(q1), "cpu").evaluate(
            io.BytesIO(lineitem), len(lineitem), frames.append)
    finally:
        os.environ.pop("MINIO_TPU_SELECT", None)
    want_records, _k = select_records(b"".join(frames))
    out: dict = {"objects": BK_OBJECTS, "object_bytes": S3_BIG,
                 "select_object_bytes": len(lineitem)}
    servers: list = []

    def signer(srv):
        return S3Signer("127.0.0.1", srv.port, cafile=srv.cafile)

    def call(srv, method, path, query=None, body=b"", headers=None):
        s = signer(srv)
        try:
            return s.request(method, path, query, body, headers)
        finally:
            s.close()

    def expect(srv, want, method, path, query=None, body=b"", headers=None):
        st, h, got = call(srv, method, path, query, body, headers)
        if st != want:
            fail(f"backends: {srv.what} {method} {path} {query or ''}: {st} "
                 f"{got[:300]!r}")
        return h, got

    def launches(srv) -> dict:
        _h, body = expect(srv, 200, "GET", f"{ADMIN}/kernel-stats")
        return {k: v for k, v in _json.loads(body)["launches"].items() if v}

    def moved(a: dict, b: dict) -> dict:
        return {k: b[k] - a.get(k, 0) for k in b if b[k] != a.get(k, 0)}

    def put_get(srv, bucket: str) -> dict:
        """S3_CLIENTS clients PUT, then GET, the objects; bodies checked."""
        jobs = [[k for j, k in enumerate(sorted(objs)) if j % S3_CLIENTS == c]
                for c in range(S3_CLIENTS)]
        cafile = srv.cafile

        def put(s, k):
            st, _h, body = s.request("PUT", f"/{bucket}/{k}", body=objs[k],
                                     payload_hash=sha[k])
            return st, body[:200]

        def get(s, k):
            st, _h, body = s.request("GET", f"/{bucket}/{k}")
            return st, hashlib.sha256(body).hexdigest() if st == 200 else body[:200]

        put_s, res = _in_clients("127.0.0.1", srv.port, jobs, put, cafile)
        if any(st != 200 for st, _b in res):
            fail(f"backends: {srv.what} PUTs {res}")
        get_s, res = _in_clients("127.0.0.1", srv.port, jobs, get, cafile)
        keys = [k for js in jobs for k in js]
        if [r for r in res] != [(200, sha[k]) for k in keys]:
            fail(f"backends: {srv.what} GET bodies differ")
        return {"put_MBps": nbytes / put_s / 1e6, "get_MBps": nbytes / get_s / 1e6,
                "put_s": put_s, "get_s": get_s}

    def select(srv, path: str) -> dict:
        t0 = time.monotonic()
        _h, body = expect(srv, 200, "POST", path, {"select": "", "select-type": "2"},
                          q1)
        took = time.monotonic() - t0
        recs, _kinds = select_records(body)
        if recs != want_records:
            fail(f"backends: {srv.what} Select Q1 answered {len(recs)} bytes of "
                 f"Records, the host engine {len(want_records)}")
        return {"s": took, "MBps": len(lineitem) / took / 1e6,
                "records_bytes": len(recs)}

    t_phase = time.monotonic()
    try:
        # -- FS and U spawned side by side ------------------------------------
        fs = _BootedServer(base, _free_port(), env, "bk-fs", drives=fs_dir,
                           what="backends FS server")
        up = _BootedServer(base, _free_port(), tls_env, "bk-u",
                           drives=os.path.join(base, "u", BK_UPSTREAM),
                           what="backends upstream U", cafile=cert)
        servers += [fs, up]
        out["spawn_to_ready_s"] = {"fs": fs.wait_ready(), "upstream": up.wait_ready()}
        if "standalone FS backend (1 drive)" not in fs.output():
            fail(f"backends: the FS server's boot: {fs.output()[-1000:]}")

        # -- FS: objects are plain files ---------------------------------------
        l0 = launches(fs)
        expect(fs, 200, "PUT", "/fsb")
        res = {"objects": put_get(fs, "fsb")}
        for k in objs:
            with open(os.path.join(fs_dir, "fsb", k), "rb") as f:
                if hashlib.sha256(f.read()).hexdigest() != sha[k]:
                    fail(f"backends: {fs_dir}/fsb/{k} is not the object's bytes")
        _h, body = expect(fs, 200, "POST", "/fsb/mp/obj", {"uploads": ""})
        uid = _xml_text(body, "UploadId")[0]
        parts = [objs["big0"][i * MP_PART:(i + 1) * MP_PART]
                 for i in range(BK_MP_PARTS)]
        etags = []
        t0 = time.monotonic()
        for n, part in enumerate(parts, 1):
            h, _b = expect(fs, 200, "PUT", "/fsb/mp/obj",
                           {"uploadId": uid, "partNumber": str(n)}, part)
            etags.append(h["etag"].strip('"'))
        expect(fs, 200, "POST", "/fsb/mp/obj", {"uploadId": uid},
               _complete_body(etags))
        res["multipart_s"] = time.monotonic() - t0
        _h, body = expect(fs, 200, "GET", "/fsb/mp/obj")
        if body != b"".join(parts):
            fail("backends: the FS multipart object's body differs")
        with open(os.path.join(fs_dir, "fsb", "mp", "obj"), "rb") as f:
            if f.read() != b"".join(parts):
                fail("backends: the FS multipart object's file differs")
        expect(fs, 200, "PUT", "/fsb/copy/big1",
               headers={"x-amz-copy-source": "/fsb/big1"})
        _h, body = expect(fs, 200, "GET", "/fsb/copy/big1")
        if hashlib.sha256(body).hexdigest() != sha["big1"]:
            fail("backends: the FS copy's body differs")
        _h, body = expect(fs, 200, "GET", "/fsb", {"delimiter": "/"})
        listed = (sorted(_xml_text(body, "Key")),
                  sorted(p for p in _xml_text(body, "Prefix") if p))
        if listed != (sorted(objs), ["copy/", "mp/"]):
            fail(f"backends: the FS delimiter listing {listed}")
        expect(fs, 200, "PUT", "/fsb/lineitem.csv", body=lineitem)
        l1 = launches(fs)
        # the first Select also starts the process's CUDA context
        res["select_Q1"] = select(fs, "/fsb/lineitem.csv")
        res["select_Q1_warm"] = select(fs, "/fsb/lineitem.csv")
        l2 = launches(fs)
        res["launches"] = moved(l0, l2)
        res["select_launches"] = moved(l1, l2)
        if backend is None:
            sel_l = res["select_launches"]
            if not all(sel_l.get(k) for k in ("select_screen", "select_positions",
                                              "select_spans[row]")):
                fail(f"backends: the FS server's Select launched {sel_l}")
            if any(k in res["launches"] for k in ("encode_pack_pipelined",
                                                  "phash256_batched")):
                fail(f"backends: the FS server launched codec kernels {res['launches']}")
        res["sigterm_s"] = fs.sigterm()
        out["fs"] = res

        # -- the NAS gateway over the directory the FS server wrote ------------
        nas = _BootedServer(base, _free_port(), env, "bk-nas",
                            drives=["gateway", "nas", fs_dir],
                            what="backends NAS gateway")
        servers.append(nas)
        res = {"spawn_to_ready_s": nas.wait_ready()}
        _h, body = expect(nas, 200, "GET", "/fsb")
        keys = sorted(_xml_text(body, "Key"))
        want = sorted([*objs, "copy/big1", "mp/obj", "lineitem.csv"])
        if keys != want:
            fail(f"backends: the NAS gateway lists {keys}, want {want}")
        t0 = time.monotonic()
        for k in objs:
            _h, body = expect(nas, 200, "GET", f"/fsb/{k}")
            if hashlib.sha256(body).hexdigest() != sha[k]:
                fail(f"backends: the NAS gateway's {k} differs")
        res["get_MBps"] = nbytes / (time.monotonic() - t0) / 1e6
        res["launches"] = launches(nas)
        res["sigterm_s"] = nas.sigterm(last="signal 15, shutting down")
        out["nas"] = res

        # -- the S3 gateway in front of U, both on TLS --------------------------
        gw_env = dict(tls_env, SSL_CERT_FILE=cert,
                      MINIO_TPU_GATEWAY_ACCESS_KEY="minioadmin",
                      MINIO_TPU_GATEWAY_SECRET_KEY="minioadmin")
        gw = _BootedServer(base, _free_port(), gw_env, "bk-gw",
                           drives=["gateway", "s3", f"https://127.0.0.1:{up.port}"],
                           what="backends S3 gateway", cafile=cert)
        servers.append(gw)
        res = {"spawn_to_ready_s": gw.wait_ready()}
        u0, g0 = launches(up), launches(gw)
        expect(gw, 200, "PUT", "/gwb")
        res["objects"] = put_get(gw, "gwb")
        u1, g1 = launches(up), launches(gw)
        res["upstream_launches"] = moved(u0, u1)
        res["gateway_launches"] = moved(g0, g1)
        if backend is None and not all(res["upstream_launches"].get(k) for k in
                                       ("encode_pack_pipelined", "phash256_batched")):
            fail(f"backends: U's K5/K2 did not launch: {res['upstream_launches']}")
        if res["gateway_launches"]:
            fail(f"backends: the S3 gateway launched {res['gateway_launches']}")
        # the first object on U's drives against the plain CPU codec
        ref_roots = [os.path.join(base, "ref", f"d{j}") for j in range(N)]
        ref = ErasureObjects([XLStorage(r) for r in ref_roots], parity_blocks=M,
                             block_size=BLOCK, device="cpu")
        ref.make_bucket("gwb")
        ref.put_object("gwb", "big0", io.BytesIO(objs["big0"]), S3_BIG)
        u_roots = [os.path.join(base, "u", f"disk{j + 1}") for j in range(N)]
        for j, (r, c) in enumerate(zip(ref_roots, u_roots)):
            if _obj_state(c, "big0", "gwb") != _obj_state(r, "big0", "gwb"):
                fail(f"backends: big0 on U's drive {j + 1} differs from the "
                     "plain codec's")
        res["held_drives"] = N
        # SSE-C passes through: PUT, GET and a copy; U holds them sealed
        plain = objs["big2"][:1 << 20]
        hdrs = ssec_headers(BK_SSEC_KEY)
        expect(gw, 200, "PUT", "/gwb/sealed", body=plain, headers=hdrs)
        _h, body = expect(gw, 200, "GET", "/gwb/sealed", headers=hdrs)
        if body != plain:
            fail("backends: the SSE-C GET through the gateway differs")
        expect(gw, 200, "PUT", "/gwb/sealed-copy", headers={
            **hdrs, **ssec_headers(BK_SSEC_KEY, copy_source=True),
            "x-amz-copy-source": "/gwb/sealed"})
        _h, body = expect(gw, 200, "GET", "/gwb/sealed-copy", headers=hdrs)
        if body != plain:
            fail("backends: the SSE-C copy through the gateway differs")
        for k in ("sealed", "sealed-copy"):
            meta = XLStorage(u_roots[0]).read_version("gwb", k).metadata
            if meta.get("x-internal-sse") != "C":
                fail(f"backends: U holds {k} unsealed: {sorted(meta)}")
            expect(up, 400, "GET", f"/gwb/{k}")  # U wants the client's key
            _h, body = expect(up, 200, "GET", f"/gwb/{k}", headers=hdrs)
            if body != plain:
                fail(f"backends: U's {k} with the key differs")
        res["ssec"] = {"bytes": len(plain), "sealed_on_upstream": 2}
        # Select on an object held in U scans on the gateway's card
        expect(up, 200, "PUT", "/gwb/lineitem.csv", body=lineitem)
        g2 = launches(gw)
        res["select_Q1"] = select(gw, "/gwb/lineitem.csv")
        res["select_Q1_warm"] = select(gw, "/gwb/lineitem.csv")
        res["select_launches"] = moved(g2, launches(gw))
        if backend is None and not all(res["select_launches"].get(k) for k in (
                "select_screen", "select_positions", "select_spans[row]")):
            fail(f"backends: the gateway's Select launched {res['select_launches']}")
        res["upstream_launches_total"] = launches(up)
        res["sigterm_s"] = gw.sigterm(last="signal 15, shutting down")
        out["s3_gateway"] = res
        out["upstream_sigterm_s"] = up.sigterm()
    finally:
        for srv in servers:
            srv.kill()
        shutil.rmtree(base, ignore_errors=True)
    out["phase_s"] = time.monotonic() - t_phase
    return out


# -- phase 13d (slice 9c): the web plane, STS and OpenID web identity ---------

WEB_DRIVES = "disk{1...12}"  # one EC 8+4 set: the BASELINE.json deployment
WEB_OBJECTS = 4  # of S3_BIG, one a client
WEB_ROUNDS = 2  # timed calls of each figure (its median is printed; cut from 3)
WEB_OFFLINE = (1, 3, 10, 12)  # erasure indices of obj0's drives taken offline
WEB_STS_REPS = 3  # cut from 5
WEB_RSA_BITS = 2048  # the stub provider's key, as OpenID providers sign
WEB_AUDIENCE = "minio-tpu-web"
WEB_READONLY_SESSION = json.dumps({
    "Version": "2012-10-17",
    "Statement": [{"Effect": "Allow", "Action": ["s3:GetObject"],
                   "Resource": ["arn:aws:s3:::*"]}]})


def _probable_prime(n: int, rnd) -> bool:
    """Miller-Rabin with 40 random bases (after trial division)."""
    for p in (3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47):
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for _ in range(40):
        x = pow(rnd.randrange(2, n - 2), d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = pow(x, 2, n)
            if x == n - 1:
                break
        else:
            return False
    return True


def rsa_keypair(bits: int, seed: int) -> "tuple[int, int, int]":
    """(n, e, d) of an RSA key made from ``seed``: two probable primes of
    ``bits // 2`` bits with the top two bits set, e = 65537."""
    import random

    rnd = random.Random(seed)
    e = 65537

    def prime() -> int:
        while True:
            c = rnd.getrandbits(bits // 2) | (3 << (bits // 2 - 2)) | 1
            if (c - 1) % e and _probable_prime(c, rnd):
                return c

    p = prime()
    q = prime()
    while q == p:
        q = prime()
    return p * q, e, pow(e, -1, (p - 1) * (q - 1))


def _b64url(data: bytes) -> str:
    import base64

    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


class _StubOpenID:
    """An OpenID provider on loopback: its discovery document and JWKS
    (one RSA key), and RS256 ID tokens (RSASSA-PKCS1-v1_5 with SHA-256)
    signed with that key."""

    def __init__(self, seed: int):
        import http.server
        import threading

        self.n, self.e, self._d = rsa_keypair(WEB_RSA_BITS, seed)
        self.kid = "web-phase-key"
        self.fetches = 0
        idp = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path == "/.well-known/openid-configuration":
                    doc = {"issuer": idp.issuer, "jwks_uri": f"{idp.issuer}/jwks"}
                elif self.path == "/jwks":
                    doc = {"keys": [{
                        "kty": "RSA", "kid": idp.kid, "alg": "RS256",
                        "n": _b64url(idp.n.to_bytes((idp.n.bit_length() + 7) // 8,
                                                    "big")),
                        "e": _b64url(idp.e.to_bytes(3, "big"))}]}
                else:
                    self.send_error(404)
                    return
                idp.fetches += 1
                body = json.dumps(doc).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._httpd.daemon_threads = True
        self.issuer = f"http://127.0.0.1:{self._httpd.server_address[1]}"
        self.config_url = f"{self.issuer}/.well-known/openid-configuration"
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def token(self, claims: dict) -> str:
        import hashlib

        header = {"alg": "RS256", "typ": "JWT", "kid": self.kid}
        body = {"iss": self.issuer, "aud": WEB_AUDIENCE,
                "exp": int(time.time()) + 3600, **claims}
        signing = (_b64url(json.dumps(header).encode()) + "."
                   + _b64url(json.dumps(body).encode()))
        k = (self.n.bit_length() + 7) // 8
        info = bytes.fromhex("3031300d060960864801650304020105000420")
        em = (b"\x00\x01" + b"\xff" * (k - 3 - len(info) - 32) + b"\x00" + info
              + hashlib.sha256(signing.encode()).digest())
        sig = pow(int.from_bytes(em, "big"), self._d, self.n).to_bytes(k, "big")
        return signing + "." + _b64url(sig)

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=10)


class _WebClient:
    """One keep-alive connection to a server's web plane."""

    def __init__(self, port: int):
        import http.client

        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)

    def call(self, method: str, path: str, body: bytes = b"",
             headers: "dict | None" = None) -> "tuple[int, dict, bytes]":
        self.conn.request(method, path, body=body or None, headers=headers or {})
        r = self.conn.getresponse()
        data = r.read()  # http.client undoes a chunked body
        return r.status, {k.lower(): v for k, v in r.getheaders()}, data

    def rpc(self, method: str, params: "dict | None" = None,
            token: "str | None" = None) -> dict:
        headers = {"Content-Type": "application/json"}
        if token:
            headers["Authorization"] = f"Bearer {token}"
        st, _h, body = self.call("POST", "/minio-tpu/webrpc", json.dumps(
            {"id": 1, "jsonrpc": "2.0", "method": method,
             "params": params or {}}).encode(), headers)
        if st != 200:
            fail(f"web: {method} answered {st} {body[:300]!r}")
        return json.loads(body)

    def close(self) -> None:
        self.conn.close()


def _median(xs: list) -> float:
    return sorted(xs)[len(xs) // 2]


def web_phase(work: str, backend: "str | None" = None) -> dict:
    """Phase 13d (slice 9c): the browser's plane of ``python -m
    minio_tpu_torch.server --parity 4`` over 12 drives (one EC 8+4 set,
    10 MiB blocks) on the async plane and the card, as MinIO's browser
    and STS clients drive it (``backend`` sets MINIO_ERASURE_BACKEND for a
    rehearsal on the CPU).

    ``web.Login`` as the root and as an IAM user, ``web.MakeBucket``;
    S3_CLIENTS clients upload WEB_OBJECTS x S3_BIG through ``PUT
    /minio-tpu/web/upload`` (K5), a web upload's part files equal an S3
    PUT's of the same payload by erasure index; each object comes back
    through ``CreateURLToken`` and ``/minio-tpu/web/download`` (K2), and
    all of them in one ``zip`` POST, unzipped here entry by entry; with
    the drives of obj0's shards WEB_OFFLINE offline (the admin fault
    endpoint) the downloads and a zip of obj0 return the same bytes (K3);
    one ``web.PresignedGet`` URL is fetched; STS ``AssumeRole`` by the root
    buys a credential whose session token PUTs and GETs one S3_BIG
    object, a read-only session policy's gets 403 on PUT;
    ``AssumeRoleWithWebIdentity`` against ``_StubOpenID`` buys one that
    GETs it; ``ListObjects`` and ``RemoveObject`` answer right and the
    console page is served.  Each figure is the median of WEB_ROUNDS
    (transfers) or WEB_STS_REPS (STS) calls."""
    import hashlib
    import threading
    import urllib.parse
    import zipfile

    import numpy as np

    from minio_tpu_torch.storage.xl import XLStorage

    base = os.path.join(work, "web")
    os.makedirs(base)
    roots = [os.path.join(base, f"disk{j + 1}") for j in range(N)]
    idp = _StubOpenID(SEED + 25)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("MINIO_TPU_") and k != "MINIO_ERASURE_BACKEND"}
    env.update({
        "MINIO_TPU_LOG_LEVEL": "warning",
        "MINIO_TPU_FAULT_INJECTION": "1",  # the admin fault endpoint
        "MINIO_TPU_IDENTITY_OPENID_CONFIG_URL": idp.config_url,
        "MINIO_TPU_IDENTITY_OPENID_CLIENT_ID": WEB_AUDIENCE,
    })
    if backend is not None:
        env["MINIO_ERASURE_BACKEND"] = backend
    rng = np.random.default_rng(SEED + 25)
    keys = [f"obj{i}" for i in range(WEB_OBJECTS)]
    objs = {k: rng.integers(0, 256, S3_BIG, dtype=np.uint8).tobytes()
            for k in keys}
    sha = {k: hashlib.sha256(v).hexdigest() for k, v in objs.items()}
    nbytes = sum(len(v) for v in objs.values())
    out: dict = {"drives": N, "objects": WEB_OBJECTS, "object_bytes": S3_BIG,
                 "rounds": WEB_ROUNDS}
    srv = None

    def admin(method: str, path: str, query=None, body: bytes = b""):
        s = S3Signer("127.0.0.1", srv.port)
        try:
            st, _h, got = s.request(method, f"{ADMIN}/{path}", query, body)
        finally:
            s.close()
        if st != 200:
            fail(f"web: admin {method} {path}: {st} {got[:300]!r}")
        return json.loads(got) if got else {}

    def launches() -> dict:
        return {k: v for k, v in admin("GET", "kernel-stats")["launches"].items()
                if v}

    def moved(a: dict, b: dict) -> dict:
        return {k: b[k] - a.get(k, 0) for k in b if b[k] != a.get(k, 0)}

    def result(doc: dict, what: str):
        if "result" not in doc:
            fail(f"web: {what}: {doc}")
        return doc["result"]

    def in_clients(jobs: list, fn) -> "tuple[float, list]":
        """fn(client, job) for each job, one client a job, all at once."""
        res: list = [None] * len(jobs)
        errors: list = []
        start = threading.Barrier(len(jobs) + 1)

        def run(ix):
            c = _WebClient(srv.port)
            try:
                start.wait()
                res[ix] = fn(c, jobs[ix])
            except BaseException as e:  # noqa: BLE001 - reported below
                errors.append(e)
            finally:
                c.close()

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(jobs))]
        for t in threads:
            t.start()
        start.wait()
        t0 = time.monotonic()
        for t in threads:
            t.join()
        wall = time.monotonic() - t0
        if errors:
            fail(f"web: a client failed: {errors[0]!r}")
        return wall, res

    def upload(c, k, token):
        st, h, body = c.call("PUT", f"/minio-tpu/web/upload/web/{k}", objs[k], {
            "Authorization": f"Bearer {token}",
            "Content-Type": "application/octet-stream"})
        if st != 200 or h.get("etag") != f'"{hashlib.md5(objs[k]).hexdigest()}"':
            fail(f"web: upload {k}: {st} {h.get('etag')} {body[:300]!r}")

    def download(c, k, url_token):
        st, h, body = c.call("GET", f"/minio-tpu/web/download/web/{k}?"
                             + urllib.parse.urlencode({"token": url_token}))
        if st != 200 or hashlib.sha256(body).hexdigest() != sha[k]:
            fail(f"web: download {k}: {st} {len(body)} bytes, not the payload")
        if h.get("content-disposition") != f'attachment; filename="{k}"':
            fail(f"web: download {k}: {h.get('content-disposition')}")

    def zip_all(url_token, names: "list | None" = None) -> float:
        """Seconds of one zip POST of ``names`` (every object by
        default); each entry unzipped and checked."""
        import io

        names = names or keys

        c = _WebClient(srv.port)
        try:
            t0 = time.monotonic()
            st, h, body = c.call(
                "POST", "/minio-tpu/web/zip?" + urllib.parse.urlencode(
                    {"token": url_token}),
                json.dumps({"bucketName": "web", "prefix": "",
                            "objects": names}).encode(),
                {"Content-Type": "application/json"})
            took = time.monotonic() - t0
        finally:
            c.close()
        if st != 200 or h.get("content-type") != "application/zip":
            fail(f"web: zip {st} {h} {body[:300]!r}")
        zf = zipfile.ZipFile(io.BytesIO(body))
        if sorted(zf.namelist()) != names:
            fail(f"web: zip entries {zf.namelist()}")
        for k in names:
            if hashlib.sha256(zf.read(k)).hexdigest() != sha[k]:
                fail(f"web: zip entry {k} differs from its payload")
        return took

    def sts(form: dict, signer: "S3Signer | None") -> "tuple[float, bytes]":
        body = urllib.parse.urlencode({"Version": "2011-06-15", **form}).encode()
        hdrs = {"Content-Type": "application/x-www-form-urlencoded"}
        t0 = time.monotonic()
        if signer is None:
            c = _WebClient(srv.port)
            try:
                st, _h, got = c.call("POST", "/", body, hdrs)
            finally:
                c.close()
        else:
            st, _h, got = signer.request("POST", "/", body=body, headers=hdrs)
        took = (time.monotonic() - t0) * 1e3
        if st != 200:
            fail(f"web: STS {form.get('Action')}: {st} {got[:300]!r}")
        return took, got

    def temp_signer(xml: bytes) -> "tuple[S3Signer, dict]":
        ak, sk, tok = (_xml_text(xml, t)[0] for t in (
            "AccessKeyId", "SecretAccessKey", "SessionToken"))
        return S3Signer("127.0.0.1", srv.port, ak, sk), {"x-amz-security-token": tok}

    t_phase = time.monotonic()
    try:
        srv = _BootedServer(base, _free_port(), env, "web", what="web phase",
                            drives=os.path.join(base, WEB_DRIVES))
        out["spawn_to_ready_s"] = srv.wait_ready()
        c = _WebClient(srv.port)
        try:
            # -- login: the root and an IAM user; the bucket -------------------
            root = result(c.rpc("web.Login", {"username": "minioadmin",
                                              "password": "minioadmin"}),
                          "root login")["token"]
            admin("PUT", "add-user", {"accessKey": "webuser"}, json.dumps(
                {"secretKey": "webuser-secret", "policy": "readwrite"}).encode())
            user = result(c.rpc("web.Login", {"username": "webuser",
                                              "password": "webuser-secret"}),
                          "IAM user login")["token"]
            if "error" not in c.rpc("web.Login", {"username": "webuser",
                                                  "password": "wrong"}):
                fail("web: a wrong password logged in")
            result(c.rpc("web.MakeBucket", {"bucketName": "web"}, root),
                   "MakeBucket")
            st, h, page = c.call("GET", "/minio-tpu/console")
            if st != 200 or not h.get("content-type", "").startswith("text/html") \
                    or b"web.Login" not in page:
                fail(f"web: the console page answered {st}")

            # -- uploads (K5), the same shards as an S3 PUT --------------------
            l0 = launches()
            up_s = []
            for r in range(WEB_ROUNDS):
                tok = root if r % 2 == 0 else user
                wall, _res = in_clients(keys, lambda cl, k: upload(cl, k, tok))
                up_s.append(wall)
            l1 = launches()
            s = S3Signer("127.0.0.1", srv.port)
            try:
                if s.request("PUT", "/s3ref")[0] != 200 or s.request(
                        "PUT", "/s3ref/obj0", body=objs["obj0"],
                        payload_hash=sha["obj0"])[0] != 200:
                    fail("web: the S3 PUT of obj0 failed")
            finally:
                s.close()
            l1s = launches()
            web_parts = {i: hashlib.sha256(b).hexdigest()
                         for i, b in _by_index(roots, "web", "obj0", 1).items()}
            s3_parts = {i: hashlib.sha256(b).hexdigest()
                        for i, b in _by_index(roots, "s3ref", "obj0", 1).items()}
            if web_parts != s3_parts or len(web_parts) != N:
                fail("web: a web upload's part files differ from an S3 PUT's")
            out["same_shards_as_s3"] = N

            # -- downloads (K2) by URL token, the zip, a presigned GET --------
            listing = result(c.rpc("web.ListObjects", {"bucketName": "web"}, user),
                             "ListObjects")
            if [(o["name"], o["size"]) for o in listing["objects"]] != [
                    (k, S3_BIG) for k in keys]:
                fail(f"web: ListObjects {listing}")
            url_tokens = [result(c.rpc("web.CreateURLToken", {}, t),
                                 "CreateURLToken")["token"] for t in (root, user)]
            down_s = []
            for r in range(WEB_ROUNDS):
                tok = url_tokens[r % 2]
                wall, _res = in_clients(keys, lambda cl, k: download(cl, k, tok))
                down_s.append(wall)
            zip_s = [zip_all(url_tokens[r % 2]) for r in range(WEB_ROUNDS)]
            url = result(c.rpc("web.PresignedGet", {
                "bucketName": "web", "objectName": "obj1"}, root),
                "PresignedGet")["url"]
            p = urllib.parse.urlsplit(url)
            st, _h, body = c.call("GET", f"{p.path}?{p.query}")
            if st != 200 or hashlib.sha256(body).hexdigest() != sha["obj1"]:
                fail(f"web: the presigned GET answered {st}")
            l2 = launches()
            out["launches"] = {"upload": moved(l0, l1), "s3_put": moved(l1, l1s),
                               "read": moved(l1s, l2)}
            if backend is None and not (
                    out["launches"]["upload"].get("encode_pack_pipelined")
                    and out["launches"]["read"].get("phash256_batched")):
                fail(f"web: launches {out['launches']}")

            # -- degraded: obj0's shards WEB_OFFLINE on drives that fail ------
            dead = [j + 1 for j, r in enumerate(roots)
                    if XLStorage(r).read_version("web", "obj0").erasure.index
                    in WEB_OFFLINE]
            for d in dead:
                admin("POST", "fault/inject", body=json.dumps(
                    {"disk": f"/disk{d}", "api": "*", "error": True}).encode())
            try:
                deg_s = []
                for r in range(WEB_ROUNDS):
                    wall, _res = in_clients(
                        keys, lambda cl, k: download(cl, k, url_tokens[0]))
                    deg_s.append(wall)
                deg_zip_s = zip_all(url_tokens[1], ["obj0"])
                l3 = launches()
                status = admin("GET", "fault/status")
            finally:
                admin("POST", "fault/clear", body=b'{"disk": "*"}')
            out["launches"]["degraded"] = moved(l2, l3)
            out["offline_drives"] = dead
            out["faults_injected"] = {
                os.path.basename(r): sum(v["injected"].values())
                for r, v in status.items() if v["injected"]}
            if sorted(int(d[4:]) for d in out["faults_injected"]) != dead:
                fail(f"web: the offline drives failed {out['faults_injected']}")
            if backend is None and not out["launches"]["degraded"].get(
                    "gf_matmul_words"):
                fail(f"web: the degraded reads launched {out['launches']['degraded']}")

            # -- STS AssumeRole by the root ------------------------------------
            root_signer = S3Signer("127.0.0.1", srv.port)
            try:
                ar_ms, xml = [], b""
                for _ in range(WEB_STS_REPS):
                    took, xml = sts({"Action": "AssumeRole",
                                     "DurationSeconds": "900"}, root_signer)
                    ar_ms.append(took)
                _t, ro_xml = sts({"Action": "AssumeRole",
                                  "Policy": WEB_READONLY_SESSION}, root_signer)
            finally:
                root_signer.close()
            tmp, hdr = temp_signer(xml)
            try:
                st, _h, body = tmp.request("PUT", "/web/sts-obj", body=objs["obj2"],
                                           headers=hdr, payload_hash=sha["obj2"])
                if st != 200:
                    fail(f"web: the AssumeRole credential's PUT: {st} {body[:200]!r}")
                st, _h, body = tmp.request("GET", "/web/sts-obj", headers=hdr)
                if st != 200 or hashlib.sha256(body).hexdigest() != sha["obj2"]:
                    fail(f"web: the AssumeRole credential's GET: {st}")
                if tmp.request("GET", "/web/sts-obj")[0] != 403:
                    fail("web: a temp credential without its token was served")
            finally:
                tmp.close()
            ro, ro_hdr = temp_signer(ro_xml)
            try:
                st, _h, _b = ro.request("PUT", "/web/ro-put", body=b"nope",
                                        headers=ro_hdr)
                if st != 403 or ro.request("GET", "/web/sts-obj",
                                           headers=ro_hdr)[0] != 200:
                    fail(f"web: the read-only session PUT answered {st}")
            finally:
                ro.close()

            # -- OpenID web identity against the stub provider ---------------
            wi_ms = []
            for i in range(WEB_STS_REPS):
                took, wi_xml = sts({
                    "Action": "AssumeRoleWithWebIdentity", "DurationSeconds": "900",
                    "WebIdentityToken": idp.token({"sub": f"web-user-{i}",
                                                   "policy": "readonly"})}, None)
                wi_ms.append(took)
                if f"<SubjectFromWebIdentityToken>web-user-{i}<".encode() \
                        not in wi_xml:
                    fail(f"web: WebIdentity answered {wi_xml[:300]!r}")
            wi, wi_hdr = temp_signer(wi_xml)
            try:
                st, _h, body = wi.request("GET", "/web/sts-obj", headers=wi_hdr)
                if st != 200 or hashlib.sha256(body).hexdigest() != sha["obj2"]:
                    fail(f"web: the WebIdentity credential's GET: {st}")
                if wi.request("PUT", "/web/wi-put", body=b"x",
                              headers=wi_hdr)[0] != 403:
                    fail("web: the readonly WebIdentity credential could PUT")
            finally:
                wi.close()
            if idp.fetches < 2:
                fail("web: the server never fetched the provider's keys")

            # -- RemoveObject and the listing after it ---------------------------
            rm = result(c.rpc("web.RemoveObject", {
                "bucketName": "web", "objects": ["sts-obj"]}, root),
                "RemoveObject")
            listing = result(c.rpc("web.ListObjects", {"bucketName": "web"}, root),
                             "ListObjects")
            if rm != {"removed": ["sts-obj"], "errors": []} or [
                    o["name"] for o in listing["objects"]] != keys:
                fail(f"web: RemoveObject {rm}, then {listing}")
        finally:
            c.close()
        out.update({
            "upload_MBps": nbytes / _median(up_s) / 1e6,
            "download_MBps": nbytes / _median(down_s) / 1e6,
            "zip_MBps": nbytes / _median(zip_s) / 1e6,
            "degraded_download_MBps": nbytes / _median(deg_s) / 1e6,
            "degraded_zip_MBps": S3_BIG / deg_zip_s / 1e6,
            "assume_role_ms": _median(ar_ms),
            "web_identity_ms": _median(wi_ms),
            "upload_s": up_s, "download_s": down_s, "zip_s": zip_s,
            "degraded_download_s": deg_s, "assume_role_all_ms": ar_ms,
            "web_identity_all_ms": wi_ms, "provider_fetches": idp.fetches,
        })
        out["sigterm_s"] = srv.sigterm()
    finally:
        if srv is not None:
            srv.kill()
        idp.close()
        shutil.rmtree(base, ignore_errors=True)
    out["phase_s"] = time.monotonic() - t_phase
    return out


# -- phase 13e: quorum-early parity acks (slice 11) -------------------------

PA_DRIVES = "disk{1...12}"  # per server: one EC 8+4 set, the BASELINE.json deployment
PA_OBJECTS = 4  # of S3_BIG, one a client
PA_TURNS = ("settle", "early", "early", "settle")  # each condition's PUT rounds
PA_SLOW_S = 0.2  # delay_s on every write of the slowed parity drive
PA_HEAL_S = 120.0  # deadline of the heal flag and of the MRF heal


def parity_key(prefix: str, count: int, bucket: str) -> "tuple[list, int]":
    """``count`` keys ``prefix<i>-<j>`` (the first j found) whose objects
    all keep a parity shard (erasure index 9-12) on one drive, and that
    drive's position in the set (its ``disk<position + 1>``)."""
    from minio_tpu_torch.objectlayer.metadata import hash_order

    keys: list = []
    drives = set(range(N))
    for i in range(count):
        for j in range(10_000):
            key = f"{prefix}{i}-{j}"
            dist = hash_order(f"{bucket}/{key}", N)
            hold = {d for d in drives if dist[d] > K}
            if hold:
                keys.append(key)
                drives = hold
                break
    return keys, min(drives)


def prom_sum(signer: "S3Signer", family: str) -> float:
    """The sum of a family's samples on the server's Prometheus page."""
    st, _h, body = signer.request("GET", "/minio-tpu/prometheus/metrics")
    if st != 200:
        fail(f"parity_ack: Prometheus answered {st}")
    return sum(float(line.rpartition(" ")[2]) for line in body.decode().splitlines()
               if line.startswith(family) and line[len(family)] in " {")


def parity_ack_phase(work: str, backend: "str | None" = None) -> dict:
    """Phase 13e (slice 11): MINIO_TPU_PARITY_ACK=early against settle on
    the BASELINE.json deployment.  Two ``python -m minio_tpu_torch.server
    --parity 4`` processes over 12 drives each (EC 8+4, 10 MiB blocks,
    the async plane, MINIO_TPU_FAULT_INJECTION=1), S under ``settle`` and
    E under ``early``, spawned at once; ``backend`` sets
    MINIO_ERASURE_BACKEND for a rehearsal on the CPU.

    In turns (PA_TURNS) S3_CLIENTS SigV4 clients PUT PA_OBJECTS x S3_BIG
    made from the seed to S or E: PUT MB/s and each PUT's time to ack
    (request to response), and a GET sent right after each ack returns
    the payload.  Then the same with one drive slowed on both servers
    (``delay_s`` PA_SLOW_S on its writes through the admin fault
    endpoint) whose shard is parity for every object of the round.  Then
    on E a parity drive's ``rename_data`` fails once: the PUT acks, the
    band heal-flags it (``miniotpu_codec_stream_heal_required_total`` +1),
    the fault is cleared and the MRF heal restores the drive's part file,
    equal by erasure index to S's for the same object.  Each server's
    launches from its admin ``kernel-stats`` over the phase."""
    import hashlib
    import threading

    import numpy as np

    from minio_tpu_torch.storage.xl import XLStorage

    base = os.path.join(work, "parity_ack")
    rng = np.random.default_rng(SEED + 26)
    objs = [rng.integers(0, 256, S3_BIG, dtype=np.uint8).tobytes()
            for _ in range(PA_OBJECTS)]
    sha = [hashlib.sha256(v).hexdigest() for v in objs]
    nbytes = sum(len(v) for v in objs)
    roots = {m: [os.path.join(base, m, f"disk{j + 1}") for j in range(N)]
             for m in ("settle", "early")}
    srv: dict = {}
    out: dict = {"drives": N, "objects": PA_OBJECTS, "object_bytes": S3_BIG,
                 "slow_delay_s": PA_SLOW_S}

    def admin(mode: str, method: str, path: str, body: bytes = b""):
        c = S3Signer("127.0.0.1", srv[mode].port)
        try:
            st, _h, got = c.request(method, f"{ADMIN}/{path}", body=body)
        finally:
            c.close()
        if st != 200:
            fail(f"parity_ack: {mode} admin {method} {path}: {st} {got[:300]!r}")
        return json.loads(got) if got else {}

    def launches(mode: str) -> dict:
        return {k: v for k, v in admin(mode, "GET", "kernel-stats")["launches"].items()
                if v}

    def put_round(mode: str, keys: list) -> dict:
        """S3_CLIENTS clients, one object each, at once: PUT, then a GET
        right after its ack."""
        ack_s = [0.0] * len(keys)
        errors: list = []
        start = threading.Barrier(len(keys) + 1)

        def client(i):
            c = S3Signer("127.0.0.1", srv[mode].port)
            try:
                start.wait()
                t0 = time.monotonic()
                st, _h, body = c.request("PUT", f"/parity/{keys[i]}", body=objs[i],
                                         payload_hash=sha[i])
                ack_s[i] = time.monotonic() - t0
                if st != 200:
                    raise RuntimeError(f"PUT {keys[i]}: {st} {body[:200]!r}")
                st, _h, body = c.request("GET", f"/parity/{keys[i]}")
                if st != 200 or hashlib.sha256(body).hexdigest() != sha[i]:
                    raise RuntimeError(f"GET {keys[i]} after the ack: {st}, "
                                       f"{len(body)} bytes, not the payload")
            except BaseException as e:  # noqa: BLE001 - reported below
                errors.append(e)
            finally:
                c.close()

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(keys))]
        for t in threads:
            t.start()
        start.wait()
        t0 = time.monotonic()
        for t in threads:
            t.join()
        if errors:
            fail(f"parity_ack: {mode}: {errors[0]!r}")
        return {"put_MBps": nbytes / max(ack_s) / 1e6, "ack_s": ack_s,
                "committed_s": committed(mode, keys, t0)}

    def committed(mode: str, keys: list, t0: float) -> float:
        """Seconds from the round's start until every drive holds every
        key's xl.meta (written last by rename_data): under early, when the
        band's parity renames have landed.  The next round starts after."""
        deadline = time.monotonic() + PA_HEAL_S
        for root in roots[mode]:
            for key in keys:
                while not os.path.exists(os.path.join(root, "parity", key, "xl.meta")):
                    if time.monotonic() > deadline:
                        fail(f"parity_ack: {mode}: {key} never reached {root}")
                    time.sleep(0.005)
        return time.monotonic() - t0

    def rounds(tag: str) -> dict:
        got: dict = {"settle": [], "early": []}
        for r, mode in enumerate(PA_TURNS):
            keys = [f"{tag}{r}-{i}" for i in range(PA_OBJECTS)]
            got[mode].append(put_round(mode, keys))
        return got

    t_phase = time.monotonic()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("MINIO_TPU_") and k != "MINIO_ERASURE_BACKEND"}
    env.update({"MINIO_TPU_LOG_LEVEL": "warning", "MINIO_TPU_FAULT_INJECTION": "1"})
    if backend is not None:
        env["MINIO_ERASURE_BACKEND"] = backend
    try:
        for mode in ("settle", "early"):
            os.makedirs(os.path.join(base, mode))
            srv[mode] = _BootedServer(
                os.path.join(base, mode), _free_port(),
                {**env, "MINIO_TPU_PARITY_ACK": mode}, f"pa-{mode}",
                drives=os.path.join(base, mode, PA_DRIVES),
                what=f"parity_ack phase ({mode})")
        out["spawn_to_ready_s"] = {m: s.wait_ready() for m, s in srv.items()}
        for mode in srv:
            c = S3Signer("127.0.0.1", srv[mode].port)
            try:
                if c.request("PUT", "/parity")[0] != 200:
                    fail(f"parity_ack: {mode}: bucket create failed")
            finally:
                c.close()
        for mode in srv:  # one untimed PUT each: the first request's set-up
            put_round(mode, ["warm"])
        l0 = {m: launches(m) for m in srv}

        # -- healthy drives: settle and early in turns ----------------------
        out["healthy"] = rounds("h")

        # -- one drive slowed, parity for every object of the round ---------
        slowed = {}
        for r in range(len(PA_TURNS)):
            keys, drive = parity_key(f"s{r}-", PA_OBJECTS, "parity")
            slowed[r] = (keys, drive)
        got: dict = {"settle": [], "early": []}
        for r, mode in enumerate(PA_TURNS):
            keys, drive = slowed[r]
            rule = {"disk": f"/disk{drive + 1}", "api": "write",
                    "delay_s": PA_SLOW_S}
            admin(mode, "POST", "fault/inject", json.dumps(rule).encode())
            try:
                res = put_round(mode, keys)  # committed under the delay too
            finally:
                admin(mode, "POST", "fault/clear", b'{"disk": "*"}')
            for key in keys:
                idx = XLStorage(roots[mode][drive]).read_version("parity", key).erasure.index
                if idx <= K:
                    fail(f"parity_ack: disk{drive + 1} holds data shard {idx} of {key}")
            res["slowed_drive"] = drive + 1
            got[mode].append(res)
        out["slowed"] = got

        # -- a parity rename that fails past the ack, heal-flagged and healed
        (key,), drive = parity_key("heal", 1, "parity")
        c = S3Signer("127.0.0.1", srv["early"].port)
        try:
            h0 = prom_sum(c, "miniotpu_codec_stream_heal_required_total")
            s0 = admin("early", "GET", "fault/status")
            admin("early", "POST", "fault/inject", json.dumps(
                {"disk": f"/disk{drive + 1}", "api": "rename_data", "error": True,
                 "calls": [1]}).encode())
            t0 = time.monotonic()
            st, _h, body = c.request("PUT", f"/parity/{key}", body=objs[0],
                                     payload_hash=sha[0])
            if st != 200:
                fail(f"parity_ack: the PUT with a failing parity rename: {st} {body[:200]!r}")
            out["heal_flag_ack_s"] = time.monotonic() - t0
            deadline = time.monotonic() + PA_HEAL_S
            while prom_sum(c, "miniotpu_codec_stream_heal_required_total") <= h0:
                if time.monotonic() > deadline:
                    fail("parity_ack: the failed parity rename was never heal-flagged")
                time.sleep(0.05)
            out["heal_flag_s"] = time.monotonic() - t0
            s1 = admin("early", "GET", "fault/status")
            admin("early", "POST", "fault/clear", b'{"disk": "*"}')
            errors = {os.path.basename(r): v["injected"].get("error", 0)
                      - s0[r]["injected"].get("error", 0) for r, v in s1.items()}
            if {d: n for d, n in errors.items() if n} != {f"disk{drive + 1}": 1}:
                fail(f"parity_ack: rename_data errors injected {errors}")
            healed_root = roots["early"][drive]
            while True:
                try:
                    XLStorage(healed_root).read_version("parity", key)
                    break
                except Exception:  # noqa: BLE001 - not healed yet
                    if time.monotonic() > deadline:
                        fail(f"parity_ack: MRF did not heal {key} on disk{drive + 1}")
                    time.sleep(0.05)
            out["mrf_heal_s"] = time.monotonic() - t0
            out["heal_required_moved"] = (
                prom_sum(c, "miniotpu_codec_stream_heal_required_total") - h0)
            if out["heal_required_moved"] != 1:
                fail(f"parity_ack: heal_required moved {out['heal_required_moved']}")
            st, _h, body = c.request("GET", f"/parity/{key}")
            if st != 200 or hashlib.sha256(body).hexdigest() != sha[0]:
                fail(f"parity_ack: GET {key} after the heal: {st}")
        finally:
            c.close()
        c = S3Signer("127.0.0.1", srv["settle"].port)
        try:
            if c.request("PUT", f"/parity/{key}", body=objs[0],
                         payload_hash=sha[0])[0] != 200:
                fail("parity_ack: the settle PUT of the healed object failed")
        finally:
            c.close()
        healed = _by_index(roots["early"], "parity", key, 1)
        if healed != _by_index(roots["settle"], "parity", key, 1) or len(healed) != N:
            fail("parity_ack: the healed object's part files differ from settle's")
        out["healed_drive"] = drive + 1
        l1 = {m: launches(m) for m in srv}
        out["launches"] = {m: {k: v - l0[m].get(k, 0) for k, v in l1[m].items()
                               if v != l0[m].get(k, 0)} for m in srv}
        if backend is None and not all(
                out["launches"][m].get("encode_pack_pipelined") for m in srv):
            fail(f"parity_ack: launches {out['launches']}")
        for cond in ("healthy", "slowed"):
            for mode in ("settle", "early"):
                runs = out[cond][mode]
                out[f"{cond}_{mode}_MBps"] = _median([r["put_MBps"] for r in runs])
                out[f"{cond}_{mode}_ack_s"] = _median(
                    [a for r in runs for a in r["ack_s"]])
                out[f"{cond}_{mode}_committed_s"] = _median(
                    [r["committed_s"] for r in runs])
        out["sigterm_s"] = {m: s.sigterm() for m, s in srv.items()}
    finally:
        for s in srv.values():
            s.kill()
        shutil.rmtree(base, ignore_errors=True)
    out["phase_s"] = time.monotonic() - t_phase
    return out


# -- phase 9c: bucket configurations enforced by the data crawler -----------

BC_TAGGED = 4  # objects of S3_BIG with x-amz-tagging, PUT by 4 clients (cut from 16, then 8)
# objects of BC_SMALL_SIZE through the object layer; cut from 2,048, at
# which the small PUTs and the two crawls took 220 s of the phase on the
# H100 machine (16 PUTs/s, 35 versions/s crawled), then from 512 (57 s of
# PUTs and crawls) so that the grid keeps four cells, then from 256 (19.5 s)
# to make room for the web phase
BC_SMALL = 128
BC_SMALL_SIZE = 4096
BC_PREFIXES = 8  # the small objects' prefixes p0/ .. p7/
BC_EXPIRED = "p3/"  # the lifecycle rule's prefix
BC_FIFO_OBJECTS = 12
BC_FIFO_SIZE = 1 << 20
BC_FIFO_QUOTA = 6 << 20
BC_LOCK_CONFIG = (
    b"<ObjectLockConfiguration><ObjectLockEnabled>Enabled"
    b"</ObjectLockEnabled><Rule><DefaultRetention><Mode>GOVERNANCE</Mode>"
    b"<Days>1</Days></DefaultRetention></Rule></ObjectLockConfiguration>"
)
BC_LIFECYCLE = (
    "<LifecycleConfiguration><Rule><ID>expire-p3</ID><Status>Enabled"
    f"</Status><Filter><Prefix>{BC_EXPIRED}</Prefix></Filter><Expiration>"
    "<Date>2020-01-01T00:00:00Z</Date></Expiration></Rule>"
    "</LifecycleConfiguration>"
).encode()


def _disk_root(disk) -> str:
    """The directory under a guarded drive's wrappers."""
    while hasattr(disk, "unwrapped"):
        disk = disk.unwrapped
    return disk.root


def _listed(signer, bucket: str) -> "tuple[int, int, list]":
    """(objects, bytes, keys) of a bucket by ListObjectsV2 pages of 1,000."""
    count = size = 0
    keys: list = []
    token = ""
    while True:
        q = {"list-type": "2", "max-keys": "1000"}
        if token:
            q["continuation-token"] = token
        st, _h, body = signer.request("GET", f"/{bucket}", q)
        if st != 200:
            fail(f"bucket_config phase: ListObjectsV2 {bucket}: {st}")
        names = _xml_text(body, "Key")
        keys += names
        count += len(names)
        size += sum(int(s) for s in _xml_text(body, "Size"))
        if _xml_text(body, "IsTruncated") != ["true"]:
            return count, size, keys
        token = _xml_text(body, "NextContinuationToken")[0]


def bucket_config_phase(dev, work: str, s3: dict,
                        backend: "str | None" = None) -> dict:
    """Phase 9c (slice 9c's first half, slice 9d's crawler): bucket
    lifecycle, object lock, tagging and quotas on the S3 phase's
    deployment (the threaded plane, 4 SigV4 clients, 12 temp-dir drives at
    EC 8+4, 10 MiB blocks), built as the server main builds it (zones over
    a set of guarded drives, the MRF heal routine, the update tracker and
    the data crawler of ``start_crawler``).  A bucket born with object
    lock and a GOVERNANCE default of one day takes BC_TAGGED x 64 MiB with
    x-amz-tagging from 4 clients (K5) and serves them back (K2), one with
    4 drives offline (K3); locked deletes are refused, the root's
    governance bypass goes, a legal hold holds; tags and retentions read
    back.  BC_SMALL x 4 KiB objects over BC_PREFIXES prefixes go in
    through the object layer, under a lifecycle rule whose Expiration Date
    is past for BC_EXPIRED; a third bucket, lock-enabled, carries a FIFO
    quota over BC_FIFO_OBJECTS objects, one of them retained.  One tagged
    object loses its files on one drive.  The admin ``crawl`` then
    expires exactly the rule's objects (GETs answer NoSuchKey), evicts
    oldest first down to the quota past the retained one, and queues the
    damaged object's heal, which the routine restores (K6, K1
    ``group=0``); ``datausage`` equals a listing; a second crawl over the
    untouched namespace skips the clean bucket."""
    import concurrent.futures
    import datetime
    import hashlib

    import numpy as np

    from minio_tpu_torch.crawler import updatetracker as ut_mod
    from minio_tpu_torch.ops import kernels
    from minio_tpu_torch.server.__main__ import (
        build_object_layer,
        start_background_heal,
        start_crawler,
    )
    from minio_tpu_torch.server.http import S3Server
    from minio_tpu_torch.storage.xl import XLStorage

    saved_env = os.environ.get("MINIO_TPU_CRAWL_INTERVAL_S")
    # the crawls of this phase are the admin's; the background cycle waits
    os.environ["MINIO_TPU_CRAWL_INTERVAL_S"] = "3600"
    base = os.path.join(work, "bcdisks")
    ol = build_object_layer([os.path.join(base, "d{1...12}")], parity=M,
                            device=backend or "cuda")
    eset = ol.zones[0].sets[0]
    roots = [_disk_root(d) for d in eset.disks]
    srv = S3Server(ol, address="127.0.0.1:0").start()
    if srv.server_mode != "threaded":
        fail(f"bucket_config phase: server plane {srv.server_mode}")
    routine, monitor = start_background_heal(ol)
    srv.heal_routine, srv.heal_queue, srv.disk_monitor = (
        routine, routine.queue, monitor)
    tracker = start_crawler(srv, ol, None, roots[0], False)
    crawler = srv.crawler
    host, port = srv.host, srv.port
    rng = np.random.default_rng(SEED + 21)
    tagged = {f"t{i:02d}": rng.bytes(S3_BIG) for i in range(BC_TAGGED)}
    tags = {k: f"phase=bucket_config&idx={i}" for i, k in enumerate(tagged)}
    sha = {k: hashlib.sha256(v).digest() for k, v in tagged.items()}
    one = S3Signer(host, port)
    out: dict = {"card": card_name()}

    def ok(res, want, what):
        st, _h, body = res
        if st != want:
            fail(f"bucket_config phase: {what}: {st} {body[:300]!r}")
        return res

    try:
        kernels.reset_launches()
        t_phase = time.monotonic()
        # a bucket born with object lock, then its default rule
        ok(one.request("PUT", "/locked", headers={
            "x-amz-bucket-object-lock-enabled": "true"}), 200,
            "CreateBucket with object lock")
        ok(one.request("PUT", "/locked", {"object-lock": ""},
                       BC_LOCK_CONFIG), 200, "PUT ?object-lock")
        st, _h, body = ok(one.request("GET", "/locked", {"object-lock": ""}),
                          200, "GET ?object-lock")
        if _xml_text(body, "Mode") != ["GOVERNANCE"] or \
                _xml_text(body, "Days") != ["1"]:
            fail(f"bucket_config phase: object-lock read back {body!r}")
        for b in ("aged", "fifo"):
            ok(one.request("PUT", f"/{b}", headers=(
                {"x-amz-bucket-object-lock-enabled": "true"}
                if b == "fifo" else None)), 200, f"CreateBucket {b}")
        ok(one.request("PUT", "/aged", {"lifecycle": ""}, BC_LIFECYCLE), 200,
           "PUT ?lifecycle")
        st, _h, body = ok(one.request("GET", "/aged", {"lifecycle": ""}),
                          200, "GET ?lifecycle")
        if _xml_text(body, "Prefix") != [BC_EXPIRED]:
            fail(f"bucket_config phase: lifecycle read back {body!r}")

        # the tagged objects, 4 clients at once (K5), stamped with the
        # bucket's default retention
        def put(signer, key):
            res = signer.request("PUT", f"/locked/{key}", body=tagged[key],
                                 unsigned_payload=True,
                                 headers={"x-amz-tagging": tags[key]})
            ok(res, 200, f"PUT {key}")
            return res[1].get("x-amz-version-id", "")

        keys = sorted(tagged)
        jobs = [keys[c::S3_CLIENTS] for c in range(S3_CLIENTS)]
        t_before = datetime.datetime.now(datetime.timezone.utc)
        put_wall, _vids = _in_clients(host, port, jobs, put)
        t_after = datetime.datetime.now(datetime.timezone.utc)

        def get(signer, key):
            st, h, body = signer.request("GET", f"/locked/{key}")
            if st != 200 or hashlib.sha256(body).digest() != sha[key]:
                fail(f"bucket_config phase: GET {key}: {st}, body differs")
            if h.get("x-amz-tagging-count") != "2":
                fail(f"bucket_config phase: GET {key} tag count "
                     f"{h.get('x-amz-tagging-count')}")
            return len(body)

        get_wall, sizes = _in_clients(host, port, jobs, get)
        # tags and retentions read back
        lo = (t_before + datetime.timedelta(days=1)).replace(microsecond=0)
        hi = t_after + datetime.timedelta(days=1)
        for key in keys:
            st, _h, body = ok(one.request("GET", f"/locked/{key}",
                                          {"tagging": ""}), 200,
                              f"GET {key}?tagging")
            want = dict(p.split("=") for p in tags[key].split("&"))
            got = dict(zip(_xml_text(body, "Key"), _xml_text(body, "Value")))
            if got != want:
                fail(f"bucket_config phase: tags of {key} {got} != {want}")
            st, _h, body = ok(one.request("GET", f"/locked/{key}",
                                          {"retention": ""}), 200,
                              f"GET {key}?retention")
            until = datetime.datetime.strptime(
                _xml_text(body, "RetainUntilDate")[0], "%Y-%m-%dT%H:%M:%SZ"
            ).replace(tzinfo=datetime.timezone.utc)
            if _xml_text(body, "Mode") != ["GOVERNANCE"] or \
                    not lo <= until <= hi:
                fail(f"bucket_config phase: retention of {key}: {body!r}")
        # one tagged object read with the drives of shards 1, 3, 10 and
        # 12 offline (K3)
        deg_key = keys[1]
        idx = {d: XLStorage(r).read_version("locked", deg_key).erasure.index
               for d, r in enumerate(roots)}
        dead = sorted(d for d, i in idx.items() if i in (1, 3, 10, 12))
        live = list(eset.disks)
        k3 = kernels.LAUNCHES["gf_matmul_words"]
        for d in dead:
            eset.disks[d] = None
        try:
            get(one, deg_key)
        finally:
            eset.disks[:] = live
        if kernels.LAUNCHES["gf_matmul_words"] <= k3:
            fail("bucket_config phase: the degraded GET reconstructed nothing")

        # the WORM guard: a retained version refuses its delete, the
        # root's bypass of GOVERNANCE goes, a legal hold holds
        vids = {}
        for key in ("bypass-me", "held"):
            st, h, _b = ok(one.request("PUT", f"/locked/{key}", body=b"w" * 64),
                           200, f"PUT {key}")
            vids[key] = h["x-amz-version-id"]
        worm = {}
        st, _h, body = one.request("DELETE", "/locked/bypass-me",
                                   {"versionId": vids["bypass-me"]})
        worm["locked_delete"] = (st, _xml_text(body, "Code"))
        if worm["locked_delete"] != (400, ["InvalidRequest"]):
            fail(f"bucket_config phase: a locked delete answered {st} {body!r}")
        st, _h, body = one.request("DELETE", "/locked/bypass-me",
                                   {"versionId": vids["bypass-me"]},
                                   headers={"x-amz-bypass-governance-retention":
                                            "true"})
        worm["bypass_delete"] = st
        if st != 204:
            fail(f"bucket_config phase: governance bypass answered {st} {body!r}")
        ok(one.request("PUT", "/locked/held", {"legal-hold": "",
                                               "versionId": vids["held"]},
                       b"<LegalHold><Status>ON</Status></LegalHold>"), 200,
           "PUT ?legal-hold ON")
        st, _h, body = one.request("DELETE", "/locked/held",
                                   {"versionId": vids["held"]},
                                   headers={"x-amz-bypass-governance-retention":
                                            "true"})
        worm["held_delete"] = (st, _xml_text(body, "Code"))
        if worm["held_delete"] != (400, ["InvalidRequest"]):
            fail(f"bucket_config phase: a held delete answered {st} {body!r}")
        st, _h, body = ok(one.request("GET", "/locked/held",
                                      {"legal-hold": ""}), 200,
                          "GET ?legal-hold")
        if _xml_text(body, "Status") != ["ON"]:
            fail(f"bucket_config phase: legal hold read back {body!r}")

        # the namespace the crawl walks: small objects through the
        # object layer, 8 threads
        small = {f"p{i % BC_PREFIXES}/o{i:05d}": rng.bytes(BC_SMALL_SIZE)
                 for i in range(BC_SMALL)}
        t0 = time.monotonic()
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            list(pool.map(
                lambda kv: ol.put_object("aged", kv[0], io.BytesIO(kv[1]),
                                         len(kv[1])),
                small.items()))
        small_put_s = time.monotonic() - t0
        # the FIFO bucket: oldest first, object 1 retained
        fifo_keys = [f"f{i:02d}" for i in range(BC_FIFO_OBJECTS)]
        for i, key in enumerate(fifo_keys):
            hdrs = ({"x-amz-object-lock-mode": "GOVERNANCE",
                     "x-amz-object-lock-retain-until-date":
                         "2090-01-01T00:00:00Z"} if i == 1 else None)
            ok(one.request("PUT", f"/fifo/{key}", body=rng.bytes(BC_FIFO_SIZE),
                           headers=hdrs), 200, f"PUT fifo/{key}")
        ok(one.request(
            "PUT", f"{ADMIN}/set-bucket-quota", {"bucket": "fifo"},
            json.dumps({"quota": BC_FIFO_QUOTA, "quotatype": "fifo"}).encode(),
        ), 200, "admin set-bucket-quota")
        # one tagged object loses its files on one drive
        damaged = keys[0]
        gone = next(d for d, r in enumerate(roots)
                    if os.path.isdir(os.path.join(r, "locked", damaged)))
        saved = {}
        obj_dir = os.path.join(roots[gone], "locked", damaged)
        for dirpath, _dirs, files in os.walk(obj_dir):
            for f in files:
                p = os.path.join(dirpath, f)
                with open(p, "rb") as fh:
                    saved[os.path.relpath(p, obj_dir)] = fh.read()
        shutil.rmtree(obj_dir)

        # crawl 1, forced through the admin API
        healed0 = routine.healed
        t0 = time.monotonic()
        st, _h, body = ok(one.request("POST", f"{ADMIN}/crawl"), 200,
                          "admin crawl")
        crawl1_s = time.monotonic() - t0
        usage1 = json.loads(body)
        stats1 = crawler.stats_snapshot()
        walked = sum(b["versions"] for b in usage1["buckets"].values()) \
            + stats1["expired"] + stats1["evicted"]
        if not routine.drain(timeout_s=300):
            fail("bucket_config phase: the heal routine did not drain")
        healed = routine.healed - healed0
        # expiry: exactly the rule's prefix, each answering NoSuchKey
        _n, _s, aged_keys = _listed(one, "aged")
        want_left = sorted(k for k in small if not k.startswith(BC_EXPIRED))
        if aged_keys != want_left:
            fail(f"bucket_config phase: {len(aged_keys)} objects left in aged, "
                 f"want {len(want_left)}")
        expired = [k for k in small if k.startswith(BC_EXPIRED)]
        if stats1["expired"] != len(expired):
            fail(f"bucket_config phase: the crawl expired {stats1['expired']}, "
                 f"want {len(expired)}")
        for key in expired[:: max(1, len(expired) // 16)]:
            st, _h, body = one.request("GET", f"/aged/{key}")
            if st != 404 or _xml_text(body, "Code") != ["NoSuchKey"]:
                fail(f"bucket_config phase: GET of expired {key}: {st}")
        # FIFO: oldest first, never the retained one, down to the quota
        _n, fifo_size, fifo_left = _listed(one, "fifo")
        evicted = [k for k in fifo_keys if k not in fifo_left]
        want_evicted = [k for k in fifo_keys if k != "f01"][
            : (BC_FIFO_OBJECTS * BC_FIFO_SIZE - BC_FIFO_QUOTA)
            // BC_FIFO_SIZE]
        if "f01" not in fifo_left or evicted != want_evicted or \
                fifo_size > BC_FIFO_QUOTA:
            fail(f"bucket_config phase: FIFO evicted {evicted}, want "
                 f"{want_evicted}; {fifo_size} B left")
        # heal: queued by the crawl's probe, restored by the routine
        if healed < 1 or stats1["heals_queued"] < 1:
            fail(f"bucket_config phase: heals queued {stats1['heals_queued']}, "
                 f"healed {healed}")
        restored = {}
        for dirpath, _dirs, files in os.walk(obj_dir):
            for f in files:
                if f != "xl.meta":
                    p = os.path.join(dirpath, f)
                    with open(p, "rb") as fh:
                        restored[os.path.relpath(p, obj_dir)] = fh.read()
        if restored != {k: v for k, v in saved.items() if k != "xl.meta"}:
            fail("bucket_config phase: the healed part files differ")
        get(one, damaged)
        # datausage against a listing of every bucket
        st, _h, body = ok(one.request("GET", f"{ADMIN}/datausage"), 200,
                          "admin datausage")
        usage = json.loads(body)
        counts = {}
        for b in ("aged", "fifo", "locked"):
            n, size, _k = _listed(one, b)
            got = usage["buckets"][b]
            counts[b] = {"listed": n, "listed_bytes": size,
                         "usage": got["objects"], "usage_bytes": got["size"]}
            if (got["objects"], got["size"]) != (n, size):
                fail(f"bucket_config phase: datausage {b} {got} != listing "
                     f"{n} objects, {size} B")
        # crawl 2 over an untouched namespace: the clean bucket skipped
        t0 = time.monotonic()
        usage2 = json.loads(ok(one.request("POST", f"{ADMIN}/crawl"), 200,
                               "admin crawl 2")[2])
        crawl2_s = time.monotonic() - t0
        stats2 = crawler.stats_snapshot()
        skipped = stats2["buckets_skipped"] - stats1["buckets_skipped"]
        if skipped != 1 or usage2["buckets"]["locked"] != \
                usage["buckets"]["locked"]:
            fail(f"bucket_config phase: crawl 2 skipped {skipped} bucket(s)")
        tracker.save()
        if not os.path.isfile(os.path.join(roots[0], ".sys",
                                           "update-tracker.bin")):
            fail("bucket_config phase: no update-tracker journal")
        phase_s = time.monotonic() - t_phase
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    finally:
        one.close()
        srv.shutdown()
        ut_mod.install_tracker(None)
        if saved_env is None:
            os.environ.pop("MINIO_TPU_CRAWL_INTERVAL_S", None)
        else:
            os.environ["MINIO_TPU_CRAWL_INTERVAL_S"] = saved_env
        shutil.rmtree(base, ignore_errors=True)

    for name in ("encode_pack_pipelined", "phash256_batched", "gf_matmul_words",
                 "verify_reconstruct_pipelined", "encode_pack[group=0]"):
        if launches.get(name, 0) <= 0:
            fail(f"bucket_config phase: kernel {name} never launched")
    nbig = sum(len(v) for v in tagged.values())
    out.update({
        "phase_s": phase_s,
        "tagged_put": {"bytes": nbig, "s": put_wall,
                       "MBps": nbig / put_wall / 1e6,
                       "s3_phase_MBps": s3["put_concurrent"]["MBps"]},
        "tagged_get": {"bytes": sum(sizes), "s": get_wall,
                       "MBps": sum(sizes) / get_wall / 1e6,
                       "s3_phase_MBps": s3["get_concurrent"]["MBps"]},
        "small_put": {"objects": BC_SMALL, "s": small_put_s,
                      "objects_per_s": BC_SMALL / small_put_s},
        "crawl": {"s": crawl1_s, "versions_walked": walked,
                  "objects_per_s": walked / crawl1_s,
                  "second_s": crawl2_s, "second_skipped_buckets": skipped},
        "expired": stats1["expired"],
        "evicted": evicted,
        "healed": healed,
        "heals_queued": stats1["heals_queued"],
        "worm": worm,
        "usage_vs_listing": counts,
        "degraded_offline_disks": dead,
        "launches": launches,
        "crawler_stats": stats2,
    })
    return out


# the TPU function each kernel replaces: encode_pack_fused (P4),
# encode_hash_fused (P2, which encode_pack computes without the pack
# leg), phash256_words_batched (left to XLA), matmul_words (P1),
# verify_reconstruct_fused (P5), the pipelined P6 and P7, the XLA
# sub-chunk steps of the async overlap chain (X2, X3), gf_matmul_mxu (P3),
# P4-P7 under the mxu formulation, and the XLA functions of S3 Select's
# device scan (X4-X7, select_step.py); and the phase whose counters each
# kernel's launches are read from.  P3 has no runtime caller in the JAX
# package, so K7 has no path of its own: its count is read from the main
# path's counters, where it is 0.
REPLACES = {
    "encode_pack": ("minio_tpu/ops/rs_pallas.py:472", "off"),
    "encode_pack[group=0]": ("minio_tpu/ops/rs_pallas.py:193", "heal"),
    "phash256_batched": ("minio_tpu/ops/hash.py:162", "main"),
    "gf_matmul_words": ("minio_tpu/ops/rs_pallas.py:84", "main"),
    "verify_reconstruct": ("minio_tpu/ops/rs_pallas.py:595", "off"),
    "encode_pack_pipelined": ("minio_tpu/ops/rs_pallas.py:802", "main"),
    "verify_reconstruct_pipelined": ("minio_tpu/ops/rs_pallas.py:970", "heal"),
    "encode_pack[subchunk]": ("minio_tpu/ops/codec_step.py:422", "async"),
    "verify_reconstruct[subchunk]": ("minio_tpu/ops/codec_step.py:486", "async"),
    "gf_matmul_mxu": ("minio_tpu/ops/rs_pallas.py:296", "main"),
    "encode_pack[mxu]": ("minio_tpu/ops/rs_pallas.py:472", "mxu off"),
    "verify_reconstruct[mxu]": ("minio_tpu/ops/rs_pallas.py:595", "mxu off"),
    "encode_pack_pipelined[mxu]": ("minio_tpu/ops/rs_pallas.py:802", "mxu pipeline"),
    "verify_reconstruct_pipelined[mxu]": ("minio_tpu/ops/rs_pallas.py:970", "mxu pipeline"),
    "select_screen": ("minio_tpu/ops/select_step.py:184", "select"),
    "select_positions": ("minio_tpu/ops/select_step.py:323", "select"),
    "select_spans[row]": ("minio_tpu/ops/select_step.py:358", "select"),
    "select_spans[back]": ("minio_tpu/ops/select_step.py:371", "select"),
    "select_gather": ("minio_tpu/ops/select_step.py:387", "select"),
    "group_flags": ("minio_tpu/ops/codec_step.py:115", "legacy"),
    "pack_nonzero_groups": ("minio_tpu/ops/codec_step.py:130", "legacy"),
}


_KERNEL_NAME = re.compile(
    r"(encode_pipelined_mxu_kernel|encode_pipelined_kernel|"
    r"verify_reconstruct_pipelined_kernel|"
    r"encode_kernel|encode_mxu_kernel|pack_kernel|phash_kernel|"
    r"gf_matmul_mxu_kernel|gf_matmul_kernel|verify_reconstruct_mxu_kernel|"
    r"verify_reconstruct_kernel|screen_kernel|positions_kernel|spans_kernel|"
    r"gather_kernel|group_flags_kernel|pack_groups_kernel)"
    r"(?:I((?:L[ib]\d+E)+)E)?"
)


def kernel_label(mangled: str) -> str:
    """A kernel's name with its template buckets in <> (swar or mxu for
    the formulation), from its mangled name."""
    m = _KERNEL_NAME.search(mangled)
    if not m:
        return mangled
    name = m.group(1)
    if name == "spans_kernel" and m.group(2):  # <BACK>
        return name + ("<back>" if m.group(2) == "Lb1E" else "<row>")
    if name == "group_flags_kernel" and m.group(2):  # <kVec>
        return name + ("<vec>" if m.group(2) == "Lb1E" else "<word>")
    if name == "pack_groups_kernel" and m.group(2):  # <kBulk>
        return name + ("<bulk>" if m.group(2) == "Lb1E" else "<staged>")
    if m.group(2):
        args = re.findall(r"L([ib])(\d+)E", m.group(2))
        name += "<" + ",".join(
            ("mxu" if v == "1" else "swar") if t == "b" else v for t, v in args
        ) + ">"
    return name


def ptxas_summary(log: str) -> list:
    """One line per compiled kernel (template buckets in <>): registers,
    shared memory and spills from nvcc's -Xptxas -v output."""
    out, name, spill = [], "?", ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = kernel_label(line.split("'")[1])
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
    return out


_SASS_INSN = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(\S.*?)\s*;")
_MMA_OPS = ("BMMA", "IMMA", "HMMA")  # the tensor-core instructions
# the instantiations sass_loops reads: K2, K6, K1 and K5 at EC 8+4 (swar
# and mxu), K3, and K4 at EC 8+4: swar and mxu at heal's pattern (<8,8,swar>,
# <8,4,mxu>) and with every row present (<16,8,swar>, <16,4,mxu>), K8 at
# each lookahead (screen_kernel<Q>; an older copy's is one screen_kernel),
# K9, both K10 forms (spans_kernel<row>, <back>), K11 and K7 at (o, s) =
# (4, 8) (gf_matmul_mxu_kernel<8,4>, <SB,OB>; an older copy's is
# gf_matmul_mxu_kernel<4>, <MB>).  An older copy's
# K4 is verify_reconstruct_kernel<16,8> (swar) and
# verify_reconstruct_mxu_kernel<PB,RB>.  K12 on an aligned plane
# (group_flags_kernel<vec>), K13's bulk-staged kernel
# (pack_groups_kernel<bulk>; an older copy's K13 is K12's launch then
# pack_kernel, which K1 and K5 launch for their pack leg).
SASS_KERNELS = ("phash_kernel", "verify_reconstruct_pipelined",
                "encode_kernel<8,4,", "encode_mxu_kernel<8,4", "gf_matmul_kernel",
                "gf_matmul_mxu_kernel<4>", "gf_matmul_mxu_kernel<8,4>",
                "encode_pipelined_kernel<8,4,", "encode_pipelined_mxu_kernel<8,4,",
                "verify_reconstruct_kernel<16,8", "verify_reconstruct_kernel<8,8,swar>",
                "verify_reconstruct_kernel<8,4,mxu>", "verify_reconstruct_kernel<16,4,mxu>",
                "verify_reconstruct_mxu_kernel<8,4>", "verify_reconstruct_mxu_kernel<16,4>",
                "screen_kernel", "positions_kernel", "spans_kernel", "gather_kernel",
                "group_flags_kernel<vec>", "pack_groups_kernel<bulk>", "pack_kernel")


def sass_loops(lib, kernels_mod) -> dict:
    """Static SASS of K1, K2, K4, K5 and K6 at EC 8+4 and K3
    (``SASS_KERNELS``; ``cuobjdump -sass`` of the built library), per
    instantiation: its instruction count and, for each loop (the span of a
    backward branch), its size, the sizes of the pieces that the branches
    inside it cut it into, and its block barriers (``bars``) and
    tensor-core instructions (``mmas``).  A thread walks one column (K1, K4-K6) or column quad (K2,
    and K3 where it loads quads) per pass of the tile loop, so its size is the
    static instruction count per column or quad; a piece that a uniform
    branch skips (a rebuilt row past the pattern's) does not run."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(kernels_mod._nvcc()), "cuobjdump")
    proc = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        fail(f"cuobjdump failed: {proc.stderr.strip()}")
    out = {}
    for body in proc.stdout.split("Function : ")[1:]:
        name = kernel_label(body.split("\n", 1)[0].strip())
        if not name.startswith(SASS_KERNELS):
            continue
        insns = []
        for line in body.splitlines():
            m = _SASS_INSN.match(line)
            if m:
                text = re.sub(r"^@!?U?P\w+\s+", "", m.group(2))
                insns.append((int(m.group(1), 16), text))
        loops = []
        for addr, text in insns:
            to = re.search(r"\b0x([0-9a-f]+)\b", text)
            if text.startswith("BRA") and to and int(to.group(1), 16) <= addr:
                span = [t for a, t in insns if int(to.group(1), 16) <= a <= addr]
                pieces, n = [], 0
                for t in span:
                    n += 1
                    if t.startswith("BRA"):
                        pieces.append(n)
                        n = 0
                loops.append({"insns": len(span), "pieces": pieces + [n] * (n > 0),
                              "bars": sum(t.startswith("BAR") for t in span),
                              "mmas": sum(t.startswith(_MMA_OPS) for t in span)})
        out[name] = {"insns": len(insns), "loops": loops}
    return out


def load_copy(path: str):
    """The kernels module of another copy of the port: PATH holds an
    ``__init__.py``, its ``ops/`` and its ``csrc/``, and builds its own
    library into PATH/build."""
    import importlib

    parent, pkg = os.path.split(os.path.abspath(path))
    sys.path.insert(0, parent)
    try:
        return importlib.import_module(f"{pkg}.ops.kernels")
    finally:
        sys.path.remove(parent)


def compare_copies(dev, mods: dict, order: list) -> list:
    """K1-K6 of several copies of the port (``mods``: name -> kernels
    module) in turns (``order``), at the main path's shapes: K1 and K5
    with the pack leg at (4, 8, 327,680) swar and mxu, without it at
    heal's (1, 8, 327,680) (K1 swar and mxu, K5 swar), K1 also at one
    tile, and K1's sub-chunk chain (X2) at (4, 8, 327,680); K2 at (32,
    327,680); K3 at the degraded GET's (4, 12, 327,680) and (1, 12,
    327,680) and one tile, shards 1, 3, 10, 12 absent; K4 and K6 at
    heal's (1, 12, 327,680) swar and mxu, with those shards absent and
    with all rows present, K4 swar also at one tile (1, 12, 256); K4's
    sub-chunk chain (X3) over heal's row in 5 chunks of 65,536 words, and
    one such chunk at word offset 65,536 (not the last: no finalize); K7
    at (4, 8, 1,310,720) bytes under the parity matrix and the 4 x 8
    reconstruction rows (``k7_recon_matrix``) and at one tile, K3 on the
    same bytes as words, and K7's phases (``k7_phases``) where the copy
    records them.  Every result is first held bit for bit against the
    plain version
    (the X3 chain's digests against the whole row's, its data once per
    copy); then cuda_ms and device_times of each."""
    import numpy as np
    import torch

    from minio_tpu_torch.ops import gf, hash as phash, rs

    heal, every = PATTERNS["data+parity missing"], PATTERNS["all present"]
    idx = tuple(i for i, p in enumerate(heal) if p)[:K]
    rmat = gf.reconstruction_matrix(K, M, idx)
    pm, r4 = gf.parity_matrix(K, M), k7_recon_matrix()
    rows = []
    for turn, name in enumerate(order):
        kern = mods[name]
        rng = np.random.default_rng(SEED)
        x2 = rand_words(rng, (4 * K, W), dev)
        x6 = rand_words(rng, (1, N, W), dev)
        x1 = rand_words(rng, (4, K, W), dev)
        x1[-1, :, 256:2048] = 0  # zero groups for the pack leg
        x3 = rand_words(rng, (4, N, W), dev)
        cases = {}
        for label, x, group, form in (
                ("K1 group=256 (4, 8, 327680)", x1, 256, "swar"),
                ("K1 group=0 (1, 8, 327680)", x1[:1], 0, "swar"),
                ("K1 group=0 one tile (1, 8, 256)", x1[:1, :, :256].contiguous(), 0, "swar"),
                ("K1 mxu group=256 (4, 8, 327680)", x1, 256, "mxu"),
                ("K1 mxu group=0 (1, 8, 327680)", x1[:1], 0, "mxu")):
            cases[label] = (
                lambda x=x, group=group, form=form: kern.encode_pack(
                    x, M, 4 * x.shape[-1], group, form),
                lambda x=x, group=group: kern.encode_pack_plain(x, M, 4 * x.shape[-1], group))
        # K5 at the PUT's shape (swar and mxu) and at B = 1 without the
        # pack leg, beside K1 at the same shapes above
        for label, x, group, form in (
                ("K5 group=256 (4, 8, 327680)", x1, 256, "swar"),
                ("K5 group=0 (1, 8, 327680)", x1[:1], 0, "swar"),
                ("K5 mxu group=256 (4, 8, 327680)", x1, 256, "mxu")):
            cases[label] = (
                lambda x=x, group=group, form=form: kern.encode_pack_pipelined(
                    x, M, 4 * x.shape[-1], group, form),
                lambda x=x, group=group: kern.encode_pack_pipelined_plain(
                    x, M, 4 * x.shape[-1], group))
        chunks = [(o, x1[:, :, o:o + 65536].contiguous()) for o in range(0, W, 65536)]

        def x2_chain(kern=kern, chunks=chunks):
            acc = torch.zeros((4, N, 8), dtype=torch.int32, device=dev)
            for i, (o, c) in enumerate(chunks):
                kern.encode_pack_subchunk(c, acc, o, M, 4 * W, 256, i == len(chunks) - 1)
            return (acc,)

        # X2: K1's sub-chunk form chained over the row (5 chunks of 65,536
        # words, as the async overlap mode cuts it), against the whole
        # row's digests
        cases["X2 chain of 5 (4, 8, 327680)"] = (
            x2_chain, lambda: (kern.encode_pack_plain(x1, M, 4 * W, 0)[1],))
        cases["K2 (32, 327680)"] = (
            lambda: kern.phash256_batched(x2, 4 * W),
            lambda: (phash.phash256_words_batched(x2, 4 * W),))
        for label, x in (("K3 (4, 12, 327680)", x3), ("K3 (1, 12, 327680)", x3[:1]),
                         ("K3 one tile (1, 12, 256)", x3[:1, :, :256].contiguous())):
            cases[label] = (lambda x=x: kern.gf_matmul_words(rmat, x, idx),
                            lambda x=x: (rs.gf_matmul_words(rmat, x, idx),))
        # K4 at heal's shape, swar and mxu, at heal's pattern and with every
        # row present (no rebuilt row)
        for label, pres, form in (("heal swar", heal, "swar"), ("heal mxu", heal, "mxu"),
                                  ("all present swar", every, "swar"),
                                  ("all present mxu", every, "mxu")):
            cases[f"K4 {label} (1, 12, 327680)"] = (
                lambda pres=pres, form=form: kern.verify_reconstruct(
                    x6, pres, K, 4 * W, formulation=form),
                lambda pres=pres: kern.verify_reconstruct_plain(x6, pres, K, 4 * W))
        x4t = x6[:, :, :256].contiguous()
        cases["K4 heal swar one tile (1, 12, 256)"] = (
            lambda: kern.verify_reconstruct(x4t, heal, K, 1024),
            lambda: kern.verify_reconstruct_plain(x4t, heal, K, 1024))
        for label, pres, form in (("heal swar", heal, "swar"), ("heal mxu", heal, "mxu"),
                                  ("all present swar", every, "swar"),
                                  ("all present mxu", every, "mxu")):
            cases[f"K6 {label} (1, 12, 327680)"] = (
                lambda pres=pres, form=form: kern.verify_reconstruct_pipelined(
                    x6, pres, K, 4 * W, formulation=form),
                lambda pres=pres: kern.verify_reconstruct_pipelined_plain(
                    x6, pres, K, 4 * W))
        # X3: K4's sub-chunk form chained over heal's row (5 chunks of
        # 65,536 words, as the async overlap mode cuts it), against the
        # whole row; and one chunk at a nonzero word offset, not the last
        vr_chunks = [(o, x6[:, :, o:o + 65536].contiguous()) for o in range(0, W, 65536)]

        def x3_chain(kern=kern, chunks=vr_chunks, outs=None):
            acc = torch.zeros((1, N, 8), dtype=torch.int32, device=dev)
            for i, (o, c) in enumerate(chunks):
                data = kern.verify_reconstruct_subchunk(c, acc, o, heal, K, 4 * W,
                                                        i == len(chunks) - 1)[0]
                if outs is not None:
                    outs.append(data)
            return (acc,)

        outs = []
        x3_chain(outs=outs)
        if not torch.equal(torch.cat(outs, dim=-1),
                           kern.verify_reconstruct_plain(x6, heal, K, 4 * W)[0]):
            fail(f"X3 chain of copy {name} does not rebuild the whole row's data")
        cases["X3 chain of 5 heal (1, 12, 327680)"] = (
            x3_chain, lambda: (kern.verify_reconstruct_plain(x6, heal, K, 4 * W)[1],))
        off, chunk = vr_chunks[1]
        acc1 = torch.zeros((1, N, 8), dtype=torch.int32, device=dev)
        cases["X3 one chunk heal (1, 12, 65536) at 65536"] = (
            lambda kern=kern: kern.verify_reconstruct_subchunk(
                chunk, acc1, off, heal, K, 4 * W),
            lambda: kern.verify_reconstruct_subchunk_plain(
                chunk, torch.zeros_like(acc1), off, heal, K, 4 * W))
        # K7 at the codec's shape under the parity matrix and the 4 x 8
        # reconstruction rows, at one tile (its fixed chain), and K3 on the
        # same bytes as words (its swar twin)
        x7 = torch.from_numpy(rng.integers(0, 256, (K, BLOCK // K), dtype=np.uint8)).to(dev)
        w7 = x7.view(torch.int32)[None]
        t7 = x7[:, :1024].contiguous()
        for label, mat, x in (("K7 parity (4, 8, 1310720)", pm, x7),
                              ("K7 recon (4, 8, 1310720)", r4, x7),
                              ("K7 one tile (4, 8, 1024)", pm, t7)):
            cases[label] = (lambda kern=kern, mat=mat, x=x: kern.gf_matmul_mxu(mat, x),
                            lambda mat=mat, x=x: (rs.gf_matmul_mxu_plain(mat, x),))
        cases["K3 parity (1, 8, 327680) on K7's bytes"] = (
            lambda kern=kern: kern.gf_matmul_words(pm, w7, tuple(range(K))),
            lambda: (rs.gf_matmul_words(pm, w7, tuple(range(K))),))
        for label, (fn, plain) in cases.items():
            got = fn()
            got = got if isinstance(got, tuple) else (got,)
            if same(got, plain()):
                fail(f"{label} of copy {name} differs from its plain version")
            rows.append({"turn": turn, "copy": name, "case": label,
                         "events_ms": cuda_ms(fn, 20, 3), **device_times(fn)})
        phases = k7_phases(kern, pm, x7)
        if phases is not None:
            rows.append({"turn": turn, "copy": name, "case": "K7 parity phases", **phases})
        torch.cuda.synchronize()
    return rows


def compare_select_copies(dev, mods: dict, order: list) -> list:
    """K8-K11 of several copies of the port (``mods``: name -> kernels
    module; each copy's ``ops.select_step``) in turns (``order``), at the
    select path's shapes: K8 on the 32 MiB lineitem chunk under Q1, Q2,
    the IN list's field screen and the programs of lookahead 3 and 6
    (``select_programs``; the latter two past the register memo); K9 at
    Q1's cap (the whole output) and Q2's; K10 ``[row]`` at Q1's anchors
    (256-byte windows) and ``[back]`` at Q2's hits (1,024); K11 at Q1's
    gather (the chunk's Q1 rows, 256-byte windows) and at one row (the
    fixed chain).  Every result is first held bit for bit against the
    plain version; then cuda_ms and device_times of each."""
    import importlib

    import numpy as np
    import torch

    from minio_tpu_torch.ops import select_step as ss
    from minio_tpu_torch.s3select import device as sdev

    rng = np.random.default_rng(SEED)
    progs = select_programs(rng)
    data = lineitem_csv(SEED + 14, sdev.DEV_CHUNK)
    plane = sdev.host_plane(data, dev)
    fd, qc = ord("|"), ord('"')
    # Q1's and Q2's candidates and positions, from the plain versions: K9's
    # inputs, the anchors and hits K10 scans from and the starts K11 gathers
    cands = {}
    for q in ("Q1", "Q2"):
        scr = progs[q]
        cand, blk, _n, _h = ss.screen_chunk_plain(
            plane, fd=fd, qc=qc, atoms=scr.atoms, anchor=scr.anchor,
            sci_guard=scr.sci_guard)
        cum = torch.cumsum(blk, 0, dtype=torch.int32)
        count = int(cum[-1].item())
        cap = 1 << max(6, (count - 1).bit_length())
        cands[q] = (cand, cum, cap, ss.extract_positions_plain(cand, cum, cap=cap)[:count])
    pos, hits = cands["Q1"][3], cands["Q2"][3]
    anchors = torch.cat([torch.full((1,), -1, dtype=torch.int32, device=dev), pos])
    starts = anchors + 1
    one = starts[:1].clone()
    rows = []
    for turn, name in enumerate(order):
        sel = importlib.import_module(mods[name].__package__ + ".select_step")
        cases = {}
        for label in ("Q1", "Q2", "IN16 field", "lookahead 3", "lookahead 6"):
            scr = progs[label]
            cases[f"K8 {label} (32 MiB)"] = (
                lambda sel=sel, scr=scr: sel.screen_chunk(
                    plane, fd=fd, qc=qc, atoms=scr.atoms, anchor=scr.anchor,
                    sci_guard=scr.sci_guard),
                lambda scr=scr: ss.screen_chunk_plain(
                    plane, fd=fd, qc=qc, atoms=scr.atoms, anchor=scr.anchor,
                    sci_guard=scr.sci_guard))
        for q, (cand, cum, cap, _p) in cands.items():
            cases[f"K9 {q} ({cap}, {cum.numel()})"] = (
                lambda sel=sel, cand=cand, cum=cum, cap=cap: (
                    sel.extract_positions(cand, cum, cap=cap),),
                lambda cand=cand, cum=cum, cap=cap: (
                    ss.extract_positions_plain(cand, cum, cap=cap),))
        cases[f"K10 row Q1 ({anchors.numel()}, 256)"] = (
            lambda sel=sel: sel.row_spans(plane, anchors, window=256),
            lambda: ss.row_spans_plain(plane, anchors, window=256))
        cases[f"K10 back Q2 ({hits.numel()}, {sdev._BACK_WINDOW})"] = (
            lambda sel=sel: sel.anchors_back(plane, hits, window=sdev._BACK_WINDOW),
            lambda: ss.anchors_back_plain(plane, hits, window=sdev._BACK_WINDOW))
        for label, st in ((f"K11 Q1 ({starts.numel()}, 256)", starts),
                          ("K11 one row (1, 256)", one)):
            cases[label] = (
                lambda sel=sel, st=st: (sel.gather_rows(plane, st, window=256),),
                lambda st=st: (ss.gather_rows_plain(plane, st, window=256),))
        for label, (fn, plain) in cases.items():
            if same(fn(), plain()):
                fail(f"{label} of copy {name} differs from its plain version")
            rows.append({"turn": turn, "copy": name, "case": label,
                         "events_ms": cuda_ms(fn, 20, 3), **device_times(fn)})
        idx = (starts.long()[:, None] + torch.arange(256, device=dev)[None, :]).clamp(
            0, plane.numel() - 1)
        rows.append({"turn": turn, "copy": "library", "case": "plane[idx] Q1",
                     "events_ms": cuda_ms(lambda: plane[idx], 20, 3)})
        torch.cuda.synchronize()
    return rows


ANALYSIS_TIMEOUT_S = 300.0
# the analysis passes that read only the source: the same answer on the
# CPU, where tests/test_torch_analysis.py runs them
STATIC_PASSES = ("lint", "locks", "deviceflow", "lifecycle")


def analysis_phase(dev, work: str) -> dict:
    """The port's static analysis on the card: ``python -m
    minio_tpu_torch.analysis --json`` as a subprocess, without the four
    passes that read only the source (the CPU tests gate those), must
    exit 0 with no finding, its contracts pass running every kernel
    wrapper and mesh kernel on CUDA tensors (the mesh over ``(cuda:0,) *
    4``) with each output equal to its plain version; every kernel's
    LAUNCHES must move in that run; and every export the ABI pass reads
    from the CUDA sources must resolve in the library this script
    built.  ``work`` is unused: the phase writes nothing."""
    import ctypes

    from minio_tpu_torch.analysis import abi_contracts
    from minio_tpu_torch.ops import kernels

    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "minio_tpu_torch.analysis", "--json",
         "--skip", *STATIC_PASSES],
        cwd=here, capture_output=True, text=True, timeout=ANALYSIS_TIMEOUT_S,
    )
    wall = time.monotonic() - t0
    try:
        doc = json.loads(proc.stdout)
    except ValueError:
        fail(f"analysis: no JSON from the CLI (rc {proc.returncode}): "
             f"{proc.stderr.strip()[-2000:]}")
    if proc.returncode != 0 or doc["findings"]:
        fail(f"analysis: rc {proc.returncode}, {len(doc['findings'])} "
             f"finding(s): {json.dumps(doc['findings'][:10])}")
    contracts = doc.get("contracts") or {}
    if not str(contracts.get("device", "")).startswith(dev.type):
        fail(f"analysis: the contracts ran on {contracts.get('device')}, "
             "not the card")
    launches = contracts.get("launches", {})
    idle = [name for name in kernels.LAUNCHES if launches.get(name, 0) <= 0]
    if idle:
        fail(f"analysis: the contracts launched no {idle}")
    lib = ctypes.CDLL(str(kernels.build()))
    exports = abi_contracts.exports()
    missing = [name for name in sorted(exports) if not hasattr(lib, name)]
    if missing:
        fail(f"analysis: exports missing from the built library: {missing}")
    return {
        "card": card_name(), "seconds": wall, "passes_s": doc["passes"],
        "findings": len(doc["findings"]), "checked": contracts.get("checked"),
        "contracts_device": contracts.get("device"),
        "callgraph": doc.get("callgraph"), "exports": len(exports),
        "launches": launches,
    }


# the copies of the port main() built (--parent's beside this checkout's),
# for the phases --only runs
COPIES: dict = {}


def legacy_only(dev) -> dict:
    """``--only legacy``: K12's and K13's checks and times
    (``check_legacy_kernels``) and, with ``--parent``, both copies' in
    turns (``compare_legacy_copies``)."""
    import numpy as np

    res = check_legacy_kernels(dev, np.random.default_rng(SEED), design=True)
    if "parent" in COPIES:
        res["compare"] = compare_legacy_copies(
            dev, COPIES, ["parent", "new", "new", "parent"])
    return res


# the phases --only can run alone: each makes its own data and servers
ONLY_PHASES = {
    "legacy": lambda dev, work: legacy_only(dev),
    "select": lambda dev, work: select_phase(dev, work),
    "cluster": lambda dev, work: cluster_phase(work),
    "federation": lambda dev, work: federation_phase(work),
    "replication": lambda dev, work: replication_phase(work),
    "backends": lambda dev, work: backends_phase(dev, work),
    "web": lambda dev, work: web_phase(work),
    "parity_ack": lambda dev, work: parity_ack_phase(work),
    "mesh": lambda dev, work: mesh_phase(dev, work),
    "analysis": lambda dev, work: analysis_phase(dev, work),
}


def run_only(dev, names: list, repeat: int) -> int:
    """``--only``: the named phases (``grid:CELL+CELL`` for grid cells),
    ``repeat`` times in turn, each run in a fresh work directory.  A run
    that fails is counted and the next one starts; prints one line a run
    and the tally."""
    global GRID_RUN

    for name in names:
        if not name.startswith("grid:") and name not in ONLY_PHASES:
            fail(f"--only: unknown phase {name!r}")
    card = card_name()
    tally = {name: {"passed": 0, "failed": 0} for name in names}
    for r in range(repeat):
        for name in names:
            work = tempfile.mkdtemp(prefix="chip_smoke-")
            t0 = time.monotonic()
            try:
                if name.startswith("grid:"):
                    GRID_RUN = tuple(name[5:].split("+"))
                    res = grid_phase(work)
                else:
                    res = ONLY_PHASES[name](dev, work)
                ok = True
            except SystemExit as e:
                res, ok = {"error": getattr(e, "message", str(e))}, False
            finally:
                shutil.rmtree(work, ignore_errors=True)
            tally[name]["passed" if ok else "failed"] += 1
            print(f"only {name} run {r + 1}: " + json.dumps(
                {"ok": ok, "s": time.monotonic() - t0, "card": card, **res}),
                flush=True)
    print(f"only: {json.dumps(tally)}", flush=True)
    return 0 if all(t["failed"] == 0 for t in tally.values()) else 1


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument(
        "--parent", metavar="DIR",
        help="another copy of the port (DIR/__init__.py, DIR/ops, DIR/csrc): "
             "build it too and time its K1-K13 beside this "
             "checkout's, in turns parent, new, new, parent")
    ap.add_argument(
        "--only", metavar="NAMES",
        help="run only these phases, comma-separated, after the build: "
             f"{', '.join(ONLY_PHASES)}, or grid:CELL[+CELL...] for cells of "
             "the chaos grid; prints each run's line and an `only:` tally "
             "and exits 1 when a run failed")
    ap.add_argument("--repeat", type=int, default=1, metavar="N",
                    help="with --only: run the phases N times in turn")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from concurrent.futures import ThreadPoolExecutor

    from minio_tpu_torch.ops import kernels, select_step

    dev = torch.device("cuda", 0)
    # the plain mxu product is a float32 matmul of 0/1 values: keep it in
    # full float32 (exact either way: counts <= 128, 0/1 exact in TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"rates: {json.dumps(int_rate())}", flush=True)
    copies = {"new": kernels}
    if args.parent:
        copies["parent"] = load_copy(args.parent)
    t0 = time.monotonic()
    # every copy's library at once, each with one nvcc per source
    with ThreadPoolExecutor(len(copies)) as pool:
        libs = dict(zip(copies, pool.map(lambda m: m.build(), copies.values())))
    build_s = time.monotonic() - t0
    for name, lib in libs.items():
        info = copies[name].BUILD_INFO
        print(f"build {name}: {build_s:.2f} s (this library "
              f"{info.get('seconds', 0.0):.2f} s; nvcc per source "
              f"{json.dumps(info.get('sources', {}))}) -> "
              f"{os.path.relpath(lib, here)}", flush=True)
        for line in ptxas_summary(info.get("log", "")):
            print("  ptxas:", line)
        print(f"  sass: {json.dumps(sass_loops(lib, kernels))}", flush=True)

    if args.only:
        COPIES.update(copies)
        return run_only(dev, args.only.split(","), args.repeat)

    import numpy as np

    # wall seconds of each phase of this run (the script's own clock)
    phases_s = {"build": build_s}
    mark = time.monotonic()

    def lap(name: str) -> None:
        nonlocal mark
        now = time.monotonic()
        phases_s[name] = now - mark
        mark = now

    rng = np.random.default_rng(SEED)
    kres = check_kernels(dev, rng)
    kres.update(check_heal_kernels(dev, rng))
    kres.update(check_overlap_kernels(dev, rng))
    kres.update(check_mxu_kernels(dev, rng))
    kres.update(check_select_kernels(dev, rng))
    kres.update(check_legacy_kernels(dev, rng))
    lap("kernel_checks")
    for name, r in kres.items():
        print(f"kernel {name}: {json.dumps(r)}", flush=True)
    print(f"legacy card: {card_name()}", flush=True)
    an = analysis_phase(dev, "")
    print("analysis: " + json.dumps(an), flush=True)
    lap("analysis")
    if args.parent:
        print(f"compare card: {card_name()}", flush=True)
        order = ["parent", "new", "new", "parent"]
        for row in compare_copies(dev, copies, order):
            print(f"compare: {json.dumps(row)}", flush=True)
        for row in compare_select_copies(dev, copies, order):
            print(f"compare: {json.dumps(row)}", flush=True)
        for row in compare_legacy_copies(dev, copies, order):
            print(f"compare: {json.dumps(row)}", flush=True)
    lap("compare")
    xfer = transfer_ms(dev)
    print(f"transfers: {json.dumps(xfer)}", flush=True)
    lap("transfers")

    # the main path and heal run under the default mode
    os.environ.pop("MINIO_TPU_CODEC_OVERLAP", None)
    work = tempfile.mkdtemp(prefix="chip_smoke-")
    try:
        payloads, written, mp = main_path(dev, work)
        print(f"main path: {json.dumps(mp)}", flush=True)
        lap("main_path")
        hp = heal_phase(dev, work, payloads)
        print(f"heal: {json.dumps(hp)}", flush=True)
        lap("heal")
        mo = modes_phase(dev, work, payloads, written, MODE_RUNS)
        lap("modes")
        mx = modes_phase(dev, work, payloads, written, MXU_RUNS)
        lap("mxu")
        mesh = mesh_phase(dev, work)
        lap("mesh")
        # phases 7, 8, 8b, 9, 9b and 9c serve in this process on the threaded plane;
        # the boot and cluster phases' servers take the default (async)
        os.environ["MINIO_TPU_SERVER"] = "threaded"
        s3 = s3_phase(dev, work, payloads, written, mp)
        lap("s3")
        s3mp = s3_mp_phase(dev, work, payloads)
        lap("s3_mp")
        sse = sse_phase(dev, work, s3)
        lap("sse")
        sel = select_phase(dev, work)
        lap("select")
        rc = read_cache_phase(dev, work, sel)
        lap("read_cache")
        bc = bucket_config_phase(dev, work, s3)
        lap("bucket_config")
        hs = heal_seq_phase(dev, work, hp["heal_object_MBps"])
        lap("heal_seq")
        os.environ.pop("MINIO_TPU_SERVER", None)
        bt = boot_phase(work, payloads)
        lap("boot")
        cl = cluster_phase(work)
        lap("cluster")
        fed = federation_phase(work)
        lap("federation")
        repl = replication_phase(work)
        lap("replication")
        bk = backends_phase(dev, work)
        lap("backends")
        web = web_phase(work)
        lap("web")
        pa = parity_ack_phase(work)
        lap("parity_ack")
        grid = grid_phase(work)
        lap("grid")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for label, by_run in (("mode", mo), ("mxu phase", mx)):
        for (formulation, mode), runs in by_run.items():
            for i, r in enumerate(runs):
                print(f"{label} {formulation} {mode} run {i + 1}: {json.dumps(r)}",
                      flush=True)
    print(f"mesh: {json.dumps(mesh)}", flush=True)
    print(f"s3: {json.dumps(s3)}", flush=True)
    print(f"s3_mp: {json.dumps(s3mp)}", flush=True)
    print(f"sse: {json.dumps(sse)}", flush=True)
    print(f"select: {json.dumps(sel)}", flush=True)
    print(f"read_cache: {json.dumps(rc)}", flush=True)
    print(f"bucket_config: {json.dumps(bc)}", flush=True)
    print(f"boot: {json.dumps(bt)}", flush=True)
    print(f"cluster: {json.dumps(cl)}", flush=True)
    card = card_name()
    print(f"heal_seq: {json.dumps({'card': card, **hs})}", flush=True)
    print(f"federation: {json.dumps({'card': card, **fed})}", flush=True)
    print(f"replication: {json.dumps({'card': card, **repl})}", flush=True)
    print(f"backends: {json.dumps({'card': card, **bk})}", flush=True)
    print(f"web: {json.dumps({'card': card, **web})}", flush=True)
    print(f"parity_ack: {json.dumps({'card': card, **pa})}", flush=True)
    print(f"grid: {json.dumps({'card': card, **grid})}", flush=True)
    print(f"phases_s: {json.dumps(phases_s)}", flush=True)
    phase_launches = {
        "main": mp["launches"], "heal": hp["launches"],
        "off": mo[("swar", "off")][0]["launches"],
        "async": mo[("swar", "async")][0]["launches"],
        "mxu off": mx[("mxu", "off")][0]["launches"],
        "mxu pipeline": mx[("mxu", "pipeline")][0]["launches"],
        "select": sel["launches"],
        # the legacy run's first turn, under MINIO_TPU_DEVICE_COMPRESS=on
        "legacy": mo[("swar", "legacy")][0]["launches"],
        "mesh": mesh["launches"],
        "analysis": an["launches"],
    }

    line = {
        "kernels": [
            {
                "name": name,
                "route": "cuda",
                "source": "minio_tpu_torch/csrc/" + (
                    "select.cu" if name in select_step.LAUNCH_NAMES else "codec.cu"),
                "replaces": replaces,
                "launches": phase_launches[phase].get(name, 0),
                # the device mesh phase's runs (its own counters)
                "mesh": phase_launches["mesh"].get(name, 0),
                # the analysis phase's contract run (its own process)
                "analysis": phase_launches["analysis"].get(name, 0),
                "max_abs_err": kres[name]["max_abs_err"],
                "ms": kres[name]["ms"],
                "plain_ms": kres[name]["plain_ms"],
                "bound_ms": kres[name]["bound_ms"],
                "bound_by": kres[name]["bound_by"],
                "library_ms": kres[name].get("library_ms"),
                **{key: kres[name][key]
                   for key in ("device_ms", "host_us", "cold_ms", "cold_read_ms")
                   if key in kres[name]},
            }
            for name, (replaces, phase) in REPLACES.items()
        ]
    }
    print(json.dumps(line), flush=True)
    print(card_name(), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
