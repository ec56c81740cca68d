#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (htslib_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's kernels from htslib_tpu_torch/csrc with nvcc, drives the
port's main path at full size through its public entry points, holds every
result against a host truth, then holds each kernel against its plain
PyTorch version on the card and times both.  Phases:

  1. the card's name and power limit (nvidia-smi);
  2. the kernel build, timed;
  3. leg 1, the BAM record-batch step: entry()'s forward over 400,000
     records (seq4 uint8 [400000, 64], starts sorted over 1 Mbp, spans of
     50-150 bp, tile 1 << 20), checked against numpy: flag sum, the bytes
     of nibble_to_base, coverage, and the step's int32 total;
  4. leg 2, the CRAM quality lane: 40 QS-sized streams of 1 MiB, encoded
     on the host with the port's rans4x16.compress(d, 0x04):
     qualstats_device must equal numpy.bincount of the raw qualities, and
     decode_nx16_o0_batch must give 8 of the streams back byte for byte;
     its wall time is printed in parts (the histogram call's framing and
     transfer, its launch and download, the checks, the decode call) and,
     after phase 6, less its kernels' times: its host side;
  4b. leg 3, the quality lane on the other rANS wires: 40 x 1 MiB Nx16
     order-1 (0x05) bounded random walks and 40 x 1 MiB rANS 4x8 streams
     (20 order 0, 20 order 1), encoded on the host with the port's codecs:
     qualstats_device_o1 and qualstats_device_4x8 (both orders) must equal
     numpy.bincount of the raw qualities, and decode_nx16_o1_batch and
     decode_4x8_o0_batch must give 8 streams each back byte for byte;
  5. the file-level lane: cram_qual_hist on each committed fixture (CRAM
     3.1 order 0, CRAM 3.1 order 1, CRAM 3.0 rANS 4x8, CRAM 3.1 STRIPE and
     PACK) must equal the histogram and block counts committed beside it,
     with blocks decoded on the device;
  5b. leg 4, the encode lane: encode_nx16_o0_batch on the card over leg
     2's 40 raw 1 MiB streams must give leg 2's host encodings byte for
     byte, and 8 of the device-encoded streams must decode (B2) back to
     their raw bytes; after the main path its host side is printed in
     parts (a second pass through the entry point's steps, each ended by a
     synchronise: the framing, the wrapper's checks, the launch and
     kernel, the payload gather and download, the headers);
  5c. leg 5, the resolve chains: make_resolve_bench (G=128 chains, 32,768
     steps, the JAX package's bench shape) and make_huffman_resolve_bench
     (L=128 chains, the same depth) must equal their numpy chains; their
     lookups per second are printed;
  5d. leg 6, whole-stream rANS batches (ops/rans.py): one
     uncompress_batch call over leg 3's 20 + 20 x 1 MiB 4x8 streams of
     both orders, mixed, and one uncompress_nx16_batch call over 8 x 1 MiB
     streams of each plain Nx16 wire, mixed: 32-way order 0 (leg 2's) and
     order 1 (leg 3's walks), 4-way order 0 (leg 2's raws) and order 1
     (leg 3's walks), encoded on the host, and with them 2 x 256 KiB
     streams of uniform random bytes on each order-1 wire (4x8, Nx16
     4-way and 32-way), whose ~65,000-row tables pass A2_MAX, and a
     PacBio-HiFi-style quality block (1.16 MB of QVs 0-93 from a seeded
     first-order Markov model, heavy at QV 93 with a long tail; its
     ~7,300 rows printed and required past 4,096) a wire: these go to the
     large-table variants of X1, X3 and B5; then each order-1 wire's 64
     KiB random stream repeated one stream past LARGE_WAVES waves of its
     large variant, a group the dense variants take; every output must
     equal its raw bytes; each launch group's framing (with a dense
     group's table build on the card within it) and decode, and the
     order-1 tables' routing parse, are printed from the entry points'
     `timing` dicts;
  5e. leg 7, the BGZF layer (ops/inflate.py, ops/bgzf_device.py).  Read
     side: leg 1's 400,000 records serialised as a BAM record stream (100
     bp, 201 bytes a record, 80.4 MB), cut into 65,280-byte members and
     deflated on the host with zlib at level 6 (1,232 members):
     inflate_batch on the card must give every member's bytes.  Write
     side: bgzf_stored_device over leg 2's 40 MiB of raw qualities (642
     full blocks and a tail): every block's CRC must equal zlib.crc32 of
     its payload and gzip.decompress must give the input back;
     crc_device_rate(n_blocks=128, reps=3) must report exact; and
     deflate_uniform_device over the first 8 MiB must gzip-decompress to
     them (its ratio and stats printed).  The read side's wall time is
     printed in parts from inflate_batch's `timing` dict: framing,
     transfer, launch and kernel, check and download, slicing;
  5f. leg 8, BAM -> SAM (ops/bam2sam.py): leg 7's inflated record stream
     (X4's output: 400,000 records of 100 bp, 80.4 MB) and a varied
     stream of 50,000 records on two references (pairs with "=", other-
     reference and no mates, negative TLENs, 1-8 CIGAR ops of M/I/D/N/S/=/X,
     2% unmapped, records without quality or SEQ, aligner aux tags with f
     and d values and B arrays), each through bam_payload_to_sam_device:
     every line must be the port's host formatter's (sam/record.py
     to_sam, in 8 processes, timed apart); each call's parts (framing, X5,
     format, download, aux, splice) from its `timing` dict, and SAM MB/s;
  5g. leg 9, BAQ (realn.py, ops/probaln.py): a seeded 1 Mbp reference and
     100,000 reads sampled from it (100 bp at 10x; 200 of 1,200-2,000 bp,
     the d = 1e-7 group; 1% substitutions, 5% with a 1-12 bp indel, 3%
     soft-clipped, 1% unmapped, 1% with BQ/ZQ tags): sam_prob_realn_batch
     with BAQ_APPLY over all of them, then over 2,000 reads for each other
     flag combination; the truth of each pass is the same pass with the
     HMM's plain version on the card: Pr, states and q of every read and
     every record after must be equal; the APPLY pass's parts (setup,
     padding, upload, X6, download, apply) from its `timing` dict;
  6. each kernel (B1, B2, B3, B5, B6, B7, B8 in both orders, X1-X3, the
     dense and large-table variants of X1, X3 and B5, B9, B4, B10, X4, X5,
     X6) against its
     plain version at the main path's shapes, and one JSON line with
     launches, error and times.  The plain versions of B5-B9
     take half a millisecond to a millisecond per round on the card, so
     they are held against their kernels at full size (X1 at leg 6's 20
     order-1 streams, the other decode rows at the 8 streams of legs 2
     and 3) over the first 4096 rounds (states, cursors, contexts, emitted words and those rounds'
     symbols or counts), and over whole streams on a 64 KiB batch; those
     of B4 and B10 run all 32,768 steps.  B5, B6, B8 order 1, X1 and X3
     are also held over a whole 64 KiB wide-alphabet stream whose lookups
     meet slow buckets.  B9 is also held, whole and against the host
     codec, on its edge streams (lengths 1, 31, 32, 33 and about its
     32-round window, one-symbol streams, f = 1 symbols).  Each chain-bound row gives
     ns_per_round (ms over its longest chain), the B2, B3, B5-B9 and X1-X3
     rows the streams one SM holds (streams_per_sm; B4 and B10
     chains_per_sm), and the B5, B6, X1-X3, B9, B4 and B10 rows their
     shared memory a block (smem_bytes); the B5/B6 rows the share of rounds
     in which some state's lookup met a slow bucket (slow_share).  The
     dense variants are held over leg 6's dense streams' first 4096 rounds;
     the large-table variants over the first 4096 rounds of leg 6's
     random streams and of its HiFi-style block, and whole over a 64 KiB
     random stream, each timed on both (ns a round, shared memory a
     block, bucket slots, streams an SM; B5 the share of rounds in which
     a lane walked).
     X4 (inflate), in both variants (the output window in a shared ring
     or in the member's slot), is held against its plain version (the
     JAX function's two passes as tensor ops, about a millisecond a step
     on the card) over chip_smoke's small members (stored, fixed,
     dynamic, long matches, multi-block, and hand-built members at the
     JAX decoder's edges, the corrupt ones refused by both), over the
     ring-edge members and over three of leg 7's own members at their
     full size (the first two and the one whose decode takes the most
     steps, each also equal to its raw bytes); both are timed over leg
     7's 1,232 members (the slot variant's side of ring_fits), over the
     first of them that fit one wave of the ring and over leg 12's
     members (the ring's side), with ns per step, blocks an SM and
     waves.  X5 (record scan), in both designs (one thread walking the
     chain, and parallel segments whose guessed entries are verified
     exactly), is held against its plain version (the JAX loop walked by
     the host) on leg 8's two payloads, on edge streams made from them
     (truncated, overrunning, a length with bit 31 set, a chain that
     stands still or jumps past the next window) and on the segmented
     walk's edges at its 64 KiB segments (crafted false entries, which
     must be walked again, past 16 of them the serial tail; a record
     longer than three segments; negative, -4 and wrapping lengths and
     max_records in a segment's middle; 0-4 byte payloads; a length not a
     multiple of 16), and timed over the 80.4 MB chain and the varied
     payload with ns per record, segments, segments walked again and
     serial-tail steps.  X1, X3 and B8 order 1 are held and timed through
     both order-1 tables (wide and compact); their rows say which one the
     row's batch takes, with ns a round, streams an SM and shared memory
     of each.  The shapes of every launch of csrc/rans4x8.cu's kernels
     (B7, B8, X1-X3) and of X5 in legs 7-13 (streams and the longest
     stream's rounds; payload bytes) are printed, so that the launches
     no timing covers can be reckoned.  X6 (probaln) is held against its
     plain version on the card over each of leg 9's HMM calls in float64
     and in float32 (the float32 run within +/-1 phred of the float64
     one), with its ns per band cell; leg 9's groups lie on both sides of
     its split (the short group a thread a read, the long group a warp a
     read), and each is also timed with every read a thread.
     Outputs are bytes and integers, so the tolerance is zero: kernel and
     plain version must be equal;
  5h. leg 10, the mesh (parallel/mesh.py, parallel/distributed.py,
     entry.dryrun_multichip), run after leg 9.  10a: this process as a
     world of one under NCCL (initialize over tcp on localhost), then
     dryrun_multichip(1) and the full-size steps below; the group is torn
     down after.  10b: 4 gloo ranks, spawned processes whose compute runs
     on cuda:0 (gloo takes host tensors, so the collectives copy through
     the host, timed apart), each running dryrun_multichip(4), the
     full-size steps and its shard of a BAM file: the decode-pileup step
     over leg 1's 400,000 records (100,000 a rank; coverage of the 1 Mbp
     tile whole on every rank, bases and flags gathered), the flagstat
     step over their flags, the halo ring over 4 tiles of 1 << 18 (halo
     1,024; each read with the rank its start falls to), and leg 7's
     stream written as a BAM file (a header member, leg 7's 1,232
     members, the EOF member) planned once into 4 shards, each rank
     decoding its shard to SAM (X4, X5, B1) and counting its flags.
     Every output is held against numpy, the shards' SAM text against leg
     8's, their summed counters against the flagstat step's; each rank's
     times, collectives (all-reduce, ring, staging) and launches are
     printed, and the sharded decode's SAM MB/s;
  5i. leg 11, CRAM -> SAM (cram/batch.py, parallel/distributed.py), run
     after leg 9, its shards in leg 10b's ranks: a seeded 2 Mbp FASTA of
     leg 8's two references, leg 8's varied records (with reads starting
     within 2 Mbp, sorted, their M/=/X bases from the FASTA with 2%
     substituted) written as BAM files.  11a: 40,000 records written by
     bam_to_cram_file as a reference-based CRAM 3.0 at 10,000 records a
     slice (4 containers), decoded whole by cram_file_to_sam on the card
     (rANS blocks through uncompress_batch / uncompress_nx16_batch, the
     records on the host, the SAM through X5 and B1), then planned into 4
     shards, each of leg 10b's ranks decoding its own.  11b: 10,000
     records as a CRAM 3.1 without a reference (rANS Nx16 4-way blocks,
     X2 and X3; names by the host TOK3 codec), decoded whole.  Blocks by
     wire are counted in a host pass first.  Truths: every data block
     decoded on the card (decode_blocks, its launches not counted) equals
     the host codec's bytes; each file's SAM text equals the host chain's
     (host codecs, the record decode, sam/record.py to_sam; a process a
     container); the shards' text in order equals 11a's.  Printed: the
     encode s, the decode s whole and in parts (blocks on the card, host
     blocks, record decode, formatting), SAM MB/s whole and over the 4
     shards, each rank's shard decode s, blocks by wire and launches;
  5j. leg 12, BCF -> VCF (vcf/io.py, parallel/distributed.py), run after
     leg 11, its shards in leg 10b's ranks: a seeded VCF in the layout of
     a GATK joint-genotyping call set (20,000 records on 2 contigs, 32
     samples; INFO DP, AC/AF (Number=A), AN, the DB flag and a short
     String; FORMAT GT:AD:DP:GQ:PL with AD Number=R and PL Number=G; 10%
     multi-allelic, 20% phased GTs, 2% missing values; FILTER PASS,
     LowQual or q10) written to BCF by vcf_file_to_bcf (host).  12a:
     bcf_file_to_vcf on the card (the file's members through X4, records
     framed and formatted on the host), then plan_bcf_shards into 4 shards
     on the card.  12b: each of leg 10b's ranks decodes its own shard
     (decode_bcf_shard_to_vcf: only its members through X4).  Truths:
     12a's text equals the host path's (zlib, the same formatter, in 8
     processes); 12a's header and records re-encoded by to_bcf (8
     processes) equal the file's inflated header and body; the shards'
     text in order equals 12a's.  Printed: the encode s, each part's time
     by the `timing` keys (read_s, inflate_s, frame_s, format_s), VCF MB/s
     whole and over the 4 shards, X4's launches in leg 12;
  5k. leg 13, the CRAM host code (cram/index.py, cram/refs.py,
     hts_expr.py, required_fields in cram/decode.py, the encoder's
     write_index and device_profile), run after leg 12 on leg 11's
     inputs; 11a's file is written with its .crai.  13a: the .crai must
     equal build_crai's entries; 16 seeded regions on both references (1
     kb to 500 kb, two across a slice boundary, one past a reference's
     end, which must hit no container), each through
     CramIndex.container_offsets and cram_range_to_sam on the card over
     each run of consecutive containers (B7, X1, X5, B1): each run's text
     must equal the host chain's over its containers (leg 11's truths),
     and its lines that overlap the region CramReader.fetch's records
     formatted by to_sam.  13b: 11a's containers decoded on the host with
     required_fields SAM_QUAL, SAM_FLAG|SAM_POS|SAM_MAPQ, SAM_SEQ|SAM_CIGAR
     and 0, a process a container: every requested field must equal the
     full decode's; each mask's decode s and blocks left compressed are
     printed.  13c: a REF_CACHE directory built from the FASTA by the
     M5 tags the encoder wrote, the FASTA moved away (its UR no longer
     resolves), 11a decoded on the card with no ref= under REF_CACHE,
     then under a REF_PATH template: both texts must equal 11a's; the
     FASTA is moved back.  13d: 11b's BAM written against the FASTA as
     CRAM 3.1 with device_profile (LEG13D_SLICE records a slice, in a
     process of its own while 13a and 13c run): every QS block of 64
     bytes or more must be on a 32-way Nx16 wire, cram_qual_hist on the
     card must equal the host codec's histogram of those blocks (B3 or
     B6) and cram_file_to_sam on the card the host chain's text (B2 or
     B5).  13e: two of 13a's regions with two filter expressions (flags
     and MAPQ; aux tags): the card's region lines of records passing
     sam_passes_filter must equal the host records that pass, and fetch
     with the expression set must yield every record of the region (the
     JAX reader's fetch does not apply the filter).  Printed: the
     regions, containers, ms a region, 13b's decode s by mask, 13c's
     seconds, 13d's encode s, decode s in parts and SAM MB/s, 13e's
     counts, leg 13's launches;
  5l. leg 14, the indexes (index.py, sam/indexing.py, vcf/io.py's CSI,
     tbx.py, faidx.py over BGZF), run after leg 10b on the files legs
     10-12 made; the host builds and truths run in a pool of processes
     while the card works.  14a: leg 10's BAM read back record by record
     by the streaming BamReader and written again with
     BamWriter(build_index=True), with LEG14_UNPLACED unplaced reads as
     its tail: its .bai must equal build_bam_index's, and a CSI
     (min_shift 14) is built too; 16 regions (one across the file's
     middle member boundary, one on the reference with no records, the
     unplaced tail by HTS_IDX_NOCOOR, 13 seeded of 1 kb to 500 kb), each's
     chunks mapped to stream offsets through the file's member table,
     inflated by bgzf.inflate_range (X4) and formatted by
     bam_payload_to_sam_device (X5, B1): the lines that overlap the
     region must equal bam_itr_query's records formatted by to_sam, over
     the BAI and over the CSI.  14b: leg 12's BCF rewritten with
     BcfWriter(build_index=True), its .csi equal to bcf_index_build's;
     16 regions on both contigs through it: chunks inflated (X4), framed
     (split_frames), the frames that overlap formatted (format_frames),
     equal to BcfReader.fetch's records as VCF.  14c: leg 12's VCF
     bgzipped and indexed by Tabix.build as TBI and as CSI; 16 regions
     inflated (X4), the lines tbx_parse1 places in the region equal to
     Tabix.query_region's over either index.  14d: leg 11's FASTA
     bgzipped with its .gzi (BgzfWriter.save_index), 64 intervals fetched
     from it equal to the plain file's, and 11a decoded by
     cram_file_to_sam with ref= the .fa.gz on the card (B7, X1, X5, B1)
     equal to 11a's text.  Printed: the wall time, ms a region by part,
     each index build's seconds, 14d's decode s in parts, the leg 14
     check line (records a region), leg 14's launches;
  5m. leg 15, the I/O layer and the file-level entry points (hfile.py,
     remote/, hts.py, opts.py, sam/fastq.py, sam/batch.py, pipeline.py),
     run after leg 14 on the files legs 10-14 made, a RangeServer on
     127.0.0.1 serving them (nothing leaves the machine); the host work
     runs in a pool of processes while the card works.  15a:
     bam_file_to_sam on leg 10's BAM (45.2 MB, 400,000 records) on the
     card (X4, X5, B1) equals leg 8's text.  15b: the same file through
     HttpFile (one request) and through an htsget+http ticket of
     LEG15_PARTS Range parts and its EOF member inline (a request a
     part), each equal to 15a's text; hts_open on the URL is a BamReader
     whose first LEG15_FIRST records are leg 8's lines.  15c: 11a decoded
     by cram_file_to_sam on the card (B7, X1, X5, B1) with its FASTA
     moved away and REF_PATH the server's M5 template: 11a's text.  15d:
     hts_open on leg 10's BAM, 11a's and 11b's CRAMs, leg 12's BCF, leg
     14's bgzipped VCF and .fa.gz and 15e's FASTQ gives the format's
     reader, with the record count and first and last records of the
     format's own reader; the first LEG15_WRITE records of 11a written by
     mode letters ("wb" level=1, "wc" with seqs_per_slice and the
     reference, "wz") read back the same.  15e: LEG15_READS paired
     150-bp reads with CASAVA comments bgzipped, imported by hts_open
     into a BAM, decoded on the card: every line's QNAME, FLAG, SEQ and
     QUAL the read's.  15f: leg 8's varied text written by
     sam_to_bam_file (pipeline_map) and decoded on the card gives it
     back.  Printed: the wall time, each sub-leg's seconds and MB/s,
     15a's parts, the requests each transport made, leg 15's launches;
  5n. leg 16, pileup (`samtools mpileup`: pileup.py,
     parallel/pileup_shard.py's model), after leg 15: leg16_records
     (LEG16_CONTIGS, 250 and 50 kb, 2 x 100 bp pairs at 30x, 90,000
     reads: a third of the pairs overlapping, indels, soft clips, the
     flags mpileup skips, unmapped reads with placed mates) written as a
     zlib level-6 BAM; the host truths run in a pool of processes while
     the card works.  16a: mpileup_text_parallel on it (X4, X5, B1 in
     this process, the tiles in the port's own pool): the inflated
     stream equals zlib's member by member, X5's offsets and sizes the
     host walk's, B1's bases the host decode's, the tile plan the plan
     from host-decoded fields, the lines in a LEG16_WINDOW window across
     every tile boundary the serial engine's over the reads overlapping
     it, and device_pileup_counts on the card for each whole reference
     the text's depth (0 where it has no column) and base counts.  16b:
     mpileup_text on the first LEG16_SMALL records as a BAM equals
     mpileup_text_parallel at LEG16_SMALL_THREADS and the engine fed by
     BamReader.read1; 16c: the same records as SAM text through
     mpileup_text (sam_text_to_bam, X5, B1) give 16b's text.  Printed:
     the wall time, 16a's parts from `timing`, columns, entries, entries
     a second and processes, 16b/16c's seconds, the leg 16 check line;
     phase 6 also holds B1, X4 and X5 against their plain versions at
     leg 16's shapes (the rows' "leg16" and "launches_leg16");
  5o. leg 17, the last slice, after leg 16 (leg17): 17a kernel P1 (the
     gather probe's resolve chain, 256 chains x 4 states x 512 rounds)
     against its plain version; 17b kernel P2 (B2's round with stages
     removed) in every mode over 32 of leg 2's streams x 2,048 rounds
     against its plain version, the full mode's symbols the raw bytes;
     17c 11a decoded on the card (B7, X1, X5, B1) with its FASTA moved
     away, REF_PATH the port's RefCacheServer whose upstream is its
     AsyncRefCacheServer: 11a's text, one upstream fetch an M5, cache
     files named by their MD5s; 17d cram_file_to_bam_stream of 11a on
     the card, formatted, gives 11a's text, and the stream equals the
     host decode's (held after the loop with leg 11's truths); 17e the
     CLI: bgzip -i/-d (X4)/-t/-b -s over leg 12's VCF text, tabix -p vcf
     and leg 14c's regions (leg 14c's lines), htsfile over legs 10-16's
     files, annot-tsv over two 10,000-row TSVs against RegIdx; phase 6
     rows P1 (resolve_cmp) and P2 (rans_ablate_<mode>, each compared
     again with its plain version there), and X4's row gains
     launches_leg17; 17a's and 17b's times are warm, from CUDA events;

Launch counts are reset just before phase 3 and read just after phase 5o,
with leg 10b's ranks' counts added; legs 7-17 are also counted alone
(reset just before each, read just after; 10b's, 11a's and 12b's shards'
in the ranks) and each must have launched its kernels (X4; X5 and B1; X6;
B1, X4 and X5 in 10a and in 10b; X5, B1 and the kernel of every rANS wire
its files hold, in leg 11 and in its shards; X4 in leg 12 and in its
shards; B1, B7, X1, X5, B2 or B5 and B3 or B6 in leg 13; X4, X5, B1, B7
and X1 in legs 14 and 15; X4, X5's segmented kernels and B1 in leg 16;
P1, P2 in every mode, X4, B7, X1, X5 and B1 in leg 17).
The kernels
line's X4 row gives leg 12's launches apart (launches_leg12).
Any mismatch raises.  The last line is {"ok": true, "device": {...}}.
Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""
from __future__ import annotations

import bisect
import gzip
import hashlib
import io
import json
import multiprocessing
import os
import re
import struct
import subprocess
import sys
import time
import zlib
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
TESTDATA = os.path.join(REPO, "htslib_tpu_torch", "testdata")
FIXTURES = [os.path.join(TESTDATA, f) for f in (
    "qual_o0.cram", "qual_o1.cram", "qual_v30.cram", "qual_stripe_pack.cram")]

N_RECORDS = 400_000
MAX_LEN = 128
TILE_LEN = 1 << 20
N_STREAMS = 40
STREAM_BYTES = 1 << 20
N_DECODE = 8
SMALL_BYTES = 1 << 16   # whole-stream kernel/plain comparisons
N_SMALL = 4
PLAIN_ROUNDS = 4096     # prefix of the full-size kernel/plain comparisons
CHAINS = 128            # resolve chains (the JAX package's bench: G=128)
CHAIN_ROUNDS = 32768    # steps of each resolve chain (its bench depth)
DENSE_BYTES = 1 << 18   # leg 6's order-1 streams past A2_MAX rows
N_DENSE = 2             # of them per order-1 wire
HIFI_BYTES = 1_160_000  # leg 6's HiFi-style quality block: a CRAM slice's QS
BAM_READ_LEN = 100      # leg 7's BAM records: leg 1's, 100 bp
BGZF_BLOCK = 0xff00     # uncompressed bytes per BGZF member (bgzf.h)
BGZF_LEVEL = 6          # bgzip's default zlib level
DEFLATE_BYTES = 8 << 20  # leg 7's deflate_uniform_device input
# peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s; 32-bit scalar
# operations are held to the non-tensor fp32 rate, the nearest listed one
HBM_BYTES_S = 3.35e12
SCALAR_OPS_S = 67e12
FP64_OPS_S = 34e12      # float64 outside the tensor cores (data sheet)
N_VARIED = 50_000       # leg 8's varied records
N_BAQ = 100_000         # leg 9's reads, a 1 Mbp region at 10x
N_BAQ_FLAG = 2_000      # leg 9's reads for each other flag combination
BAQ_OPS_PER_CELL = 40   # X6's work a band cell (forward, backward, MAP)
N_RANKS = 4             # leg 10b's gloo ranks
HALO_TILE = 1 << 18     # leg 10's coordinate tiles: 4 over 1 Mbp
HALO = 1024             # and their halo (a read spans at most 150 bp)
LEG10_TIMEOUT = 300     # seconds leg 10b's ranks may take together
N_CRAM = 40_000         # leg 11a's records, 4 slices
N_CRAM31 = 10_000       # leg 11b's records, one slice
CRAM_SLICE = 10_000     # records a slice: htslib's default
CRAM_SPAN = 2_000_000   # leg 11's reads start within 2 Mbp of a reference
N_REGIONS = 16          # leg 13a's region queries on 11a's file
LEG13D_SLICE = 2_500    # records a slice of 13d's CRAM 3.1 (4 slices)
LEG13_FILTERS = ["mapq >= 30 && flag.paired",
                 'exists([XS]) && [RG] != "grp1" && [NM] < 6']
N_VCF = 20_000          # leg 12's VCF records, on LEG12_CONTIGS
N_SAMPLES = 32          # and their samples
LEG12_CONTIGS = [("chr1", 248956422), ("chr2", 242193529)]
LEG14_UNPLACED = 2_000  # leg 14a's unmapped, unplaced tail (HTS_IDX_NOCOOR)
LEG15_READS = 100_000   # 15e's FASTQ reads, 150 bp, in pairs
LEG15_READ_LEN = 150
LEG15_FIRST = 1_000     # 15b's records read by hts_open over http
LEG15_WRITE = 4_000     # 15d's records written back by mode letters
LEG15_PARTS = 4         # 15b's htsget ticket: byte ranges of the file
# leg 16's pileup: two references cut from a whole genome to 300 kb for
# the script's time limit, 2 x 100 bp pairs at 30x (90,000 reads)
LEG16_CONTIGS = [("chr1", 250_000), ("chr2", 50_000)]
LEG16_DEPTH = 30
LEG16_READ_LEN = 100
LEG16_WINDOW = 10_000   # 16a's check windows across the tile boundaries
LEG16_SMALL = 3_000     # 16b's and 16c's records
LEG16_SMALL_THREADS = 3
LEG16_PLAIN_BYTES = 2048  # X4's member against its plain version
LEG17_TSV_ROWS = 10_000  # 17e's annot-tsv inputs: rows of each TSV
LEG17_OFFSETS = 16      # 17e's bgzip -b/-s reads


class RangeServer:
    """An HTTP server on 127.0.0.1 (a free port), in a thread of this
    process, for the remote paths: GET of /PATH answers `extra[PATH]`
    (bytes) or the file PATH under `root`, whole or, for one `Range:
    bytes=A-B` or `bytes=A-` header, as 206 with its Content-Range.
    `requests` logs each request's (path, Range header, headers).  A
    context manager; `url(path)` is the full URL."""

    def __init__(self, root: str, extra=None):
        import http.server
        import threading
        import urllib.parse
        srv = self
        self.root = root
        self.extra = dict(extra or {})
        self.requests = []

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                path = urllib.parse.unquote(self.path.split("?")[0])
                rng = self.headers.get("Range")
                srv.requests.append((path, rng, dict(self.headers)))
                body = srv.extra.get(path)
                name = os.path.join(srv.root, path.lstrip("/"))
                if body is None and not os.path.isfile(name):
                    self.send_error(404)
                    return
                size = len(body) if body is not None else os.path.getsize(
                    name)
                lo, hi = 0, size - 1
                if rng:
                    a, _, b = rng.split("=", 1)[1].partition("-")
                    lo, hi = int(a), min(int(b) if b else size - 1, size - 1)
                    if lo >= size:
                        self.send_error(416)
                        return
                self.send_response(206 if rng else 200)
                self.send_header("Content-Length", str(hi - lo + 1))
                if rng:
                    self.send_header("Content-Range",
                                     f"bytes {lo}-{hi}/{size}")
                self.end_headers()
                try:
                    if body is not None:
                        self.wfile.write(body[lo:hi + 1])
                        return
                    with open(name, "rb") as fp:
                        fp.seek(lo)
                        left = hi - lo + 1
                        while left:
                            chunk = fp.read(min(left, 1 << 20))
                            if not chunk:
                                break
                            self.wfile.write(chunk)
                            left -= len(chunk)
                except (BrokenPipeError, ConnectionResetError):
                    pass        # the client closed early (a seek, a peek)

            def log_message(self, *args):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                     Handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def url(self, path: str) -> str:
        return f"http://127.0.0.1:{self.port}/{path.lstrip('/')}"

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def htsget_ticket(url: str, size: int, parts: int, tail: bytes = b""
                  ) -> bytes:
    """An htsget ticket (JSON) for the first `size` bytes of `url` in
    `parts` byte ranges of about equal length, each an http part with its
    Range header, then `tail` as an inline base64 `data:` part."""
    import base64
    cuts = [size * i // parts for i in range(parts + 1)]
    urls = [{"url": url, "headers": {"Range": f"bytes={a}-{b - 1}"}}
            for a, b in zip(cuts, cuts[1:]) if b > a]
    if tail:
        urls.append({"url": "data:application/octet-stream;base64,"
                     + base64.b64encode(tail).decode()})
    return json.dumps({"htsget": {"format": "BAM", "urls": urls}}).encode()


def _encode(data: bytes, wire: str = "nx16_o0") -> bytes:
    """One stream on one rANS wire, with the port's own host codecs."""
    from htslib_tpu_torch.bench_rans import encode
    return encode(data, wire)


def _encode_all(raws, wires, pool=None):
    """Each stream on its wire, in `pool` or in a spawned pool of their
    own."""
    if pool is not None:
        return list(pool.map(_encode, raws, wires, chunksize=1))
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                             mp_context=ctx) as own:
        return list(own.map(_encode, raws, wires, chunksize=1))


def _host_sam(payload: bytes, refs) -> bytes:
    """The port's host formatter (sam/record.py to_sam) over every record
    of a u32-framed stream: the truth of leg 8."""
    from htslib_tpu_torch.sam.header import SamHeader
    from htslib_tpu_torch.sam.record import BamRecord
    hdr = SamHeader(ref_names=refs)
    mv = memoryview(payload)
    out, p = [], 0
    while p < len(payload):
        n = int.from_bytes(payload[p:p + 4], "little")
        out.append(BamRecord.from_bam_buffer(mv, p + 4, n).to_sam(hdr))
        p += 4 + n
    return ("\n".join(out) + "\n").encode() if out else b""


def host_sam_parallel(payload: bytes, refs, parts: int = 8) -> bytes:
    """_host_sam over record-aligned pieces of the stream, in processes."""
    cuts, p, step = [0], 0, max(1, len(payload) // parts)
    while p < len(payload):
        p += 4 + int.from_bytes(payload[p:p + 4], "little")
        if p - cuts[-1] >= step or p >= len(payload):
            cuts.append(p)
    pieces = [payload[a:b] for a, b in zip(cuts, cuts[1:])]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=min(parts, os.cpu_count() or 1),
                             mp_context=ctx) as pool:
        return b"".join(pool.map(_host_sam, pieces, [refs] * len(pieces)))


def _walks(rng, n: int, size: int, read: int = 100):
    """n quality streams of `size` bytes: bounded random walks over 2..41,
    one per read of `read` bp, as a QS series concatenates its reads."""
    k = -(-size // read)
    out = []
    for _ in range(n):
        q = np.clip(rng.integers(25, 38, (k, 1))
                    + np.cumsum(rng.integers(-2, 3, (k, read)), axis=1),
                    2, 41)
        out.append(q.reshape(-1)[:size].astype(np.uint8).tobytes())
    return out


def leg1_batch(n: int = N_RECORDS, seed: int = 1):
    """Records for the record-batch step: random cores and packed
    sequences, sorted starts over 1 Mbp, spans of 50-150 bp."""
    rng = np.random.default_rng(seed)
    cores = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    seq4 = rng.integers(0, 256, (n, MAX_LEN // 2), dtype=np.uint8)
    starts = np.sort(rng.integers(0, 1_000_000, n)).astype(np.int32)
    ends = (starts + rng.integers(50, 151, n)).astype(np.int32)
    return cores, seq4, starts, ends, np.ones(n, bool)


def leg2_streams(n: int = N_STREAMS, size: int = STREAM_BYTES,
                 seed: int = 2, pool=None):
    """QS-sized quality streams, raw and encoded (in `pool` where given):
    most uniform over 20..40, the last fifth bounded random walks over
    0..44."""
    rng = np.random.default_rng(seed)
    raws = []
    for i in range(n):
        if i < n - n // 5:
            q = rng.integers(20, 41, size, dtype=np.uint8)
        else:
            q = np.clip(np.cumsum(rng.integers(-2, 3, size)) + 20,
                        0, 44).astype(np.uint8)
        raws.append(q.tobytes())
    return raws, _encode_all(raws, ["nx16_o0"] * n, pool)


def leg3_streams(n: int = N_STREAMS, size: int = STREAM_BYTES,
                 small: int = SMALL_BYTES, n_small: int = N_SMALL,
                 seed: int = 3, pool=None):
    """QS-sized streams on the other rANS wires, raw and encoded (in
    `pool` where given), with
    n_small streams of `small` bytes per wire for the whole-stream
    comparisons: {wire: (raws, encs, small raws, small encs)} for wires
    nx16_o1 (n bounded random walks), 4x8_o0 (n/2, uniform over 20..40)
    and 4x8_o1 (n/2 random walks), and under "4x8_o1_wide" one (raw,
    encoded) 4x8 order-1 `wide_stream` of `small` bytes, and under
    "nx16_o1_wide" the same bytes on the Nx16 order-1 wire."""
    rng = np.random.default_rng(seed)
    half = n // 2
    raws = {"nx16_o1": _walks(rng, n, size),
            "4x8_o0": [rng.integers(20, 41, size, dtype=np.uint8).tobytes()
                       for _ in range(half)],
            "4x8_o1": _walks(rng, half, size)}
    smalls = {w: (_walks(rng, n_small, small) if w.endswith("o1")
                  else [rng.integers(20, 41, small, dtype=np.uint8)
                        .tobytes() for _ in range(n_small)])
              for w in raws}
    jobs = [(w, d) for w, ds in list(raws.items()) + list(smalls.items())
            for d in ds]
    encs = _encode_all([d for _, d in jobs], [w for w, _ in jobs], pool)
    out, k = {}, 0
    for w in raws:
        out[w] = [raws[w], encs[k:k + len(raws[w])]]
        k += len(raws[w])
    for w in raws:
        out[w] += [smalls[w], encs[k:k + n_small]]
        k += n_small
    wide = wide_stream(rng, small)
    out["4x8_o1_wide"] = (wide, _encode(wide, "4x8_o1"))
    out["nx16_o1_wide"] = (wide, _encode(wide, "nx16_o1"))
    return out


def leg6_streams(raws2, leg3, n: int = N_DECODE, seed: int = 6,
                 pool=None):
    """The 4-way Nx16 wires in leg 3's form, encoded in `pool` where
    given: {"nx16_4way_o0": [raws,
    encs, small raws, small encs] (n of leg 2's raws, leg 3's uniform
    64 KiB streams), "nx16_4way_o1": the same of leg 3's walks, and
    "nx16_4way_o1_wide": leg 3's wide-alphabet stream (raw, encoded)};
    and for each order-1 wire W in 4x8_o1, nx16_o1 and nx16_4way_o1, under
    "W_dense", N_DENSE streams of DENSE_BYTES uniform random bytes (raws,
    encs): order-1 tables of ~65,000 rows, past the record kernels'
    A2_MAX; under "W_hifi" the HiFi-style quality block (`hifi_qualities`,
    about 7,300 rows; ([raw], [enc])); under "W_spill" one SMALL_BYTES
    stream of uniform random bytes (raw, enc; about 41,000 rows), which
    leg 6 repeats past the large variants' waves, so that its group goes
    to the dense variants."""
    sets = {"nx16_4way_o0": (raws2[:n], leg3["4x8_o0"][2]),
            "nx16_4way_o1": (leg3["nx16_o1"][0][:n], leg3["nx16_o1"][2])}
    jobs = [(w, d) for w, (big, small) in sets.items() for d in big + small]
    jobs.append(("nx16_4way_o1", leg3["nx16_o1_wide"][0]))
    rng = np.random.default_rng(seed)
    dense = {w: [rng.integers(0, 256, DENSE_BYTES, dtype=np.uint8).tobytes()
                 for _ in range(N_DENSE)]
             for w in ("4x8_o1", "nx16_o1", "nx16_4way_o1")}
    hifi = hifi_qualities()
    spill = rng.integers(0, 256, SMALL_BYTES, dtype=np.uint8).tobytes()
    for w in dense:
        dense[w] += [hifi, spill]
    jobs += [(w, d) for w, ds in dense.items() for d in ds]
    encs = _encode_all([d for _, d in jobs], [w for w, _ in jobs], pool)
    out, k = {}, 0
    for w, (big, small) in sets.items():
        out[w] = [big, encs[k:k + len(big)], small,
                  encs[k + len(big):k + len(big) + len(small)]]
        k += len(big) + len(small)
    out["nx16_4way_o1_wide"] = (jobs[k][1], encs[k])
    k += 1
    for w, ds in dense.items():
        out[f"{w}_dense"] = (ds[:N_DENSE], encs[k:k + N_DENSE])
        out[f"{w}_hifi"] = ([hifi], [encs[k + N_DENSE]])
        out[f"{w}_spill"] = (spill, encs[k + N_DENSE + 1])
        k += len(ds)
    return out


def hifi_qualities(n: int = HIFI_BYTES, seed: int = 16, floor: float = 0.02,
                   top: float = 0.55) -> bytes:
    """n PacBio-HiFi-style base qualities, QV 0-93 as a CRAM QS block holds
    them, from a seeded first-order Markov model: QV 93 (the SAM ceiling)
    with probability `top`; a jump to the tail (QV 0-92, weighted
    exp(-(92 - q) / 20) + floor, so heavier near the top) with 0.2; else a
    step of a two-sided geometric size from the previous value, clipped to
    0-93.  At 1.16 MB the order-1 table has about 7,300 (context, symbol)
    rows of 94 x 94, past A2_MAX; a larger `floor` widens the tail (and a
    smaller `top` thins the mode), so fewer bytes pass it."""
    rng = np.random.default_rng(seed)
    comp = rng.random(n)
    q = np.arange(93)
    tail = np.exp(-(92 - q) / 20.0) + floor
    val = np.where(comp < top, 93, -1).astype(np.int64)
    jump = comp >= 0.8
    val[jump] = rng.choice(93, int(jump.sum()), p=tail / tail.sum())
    step = rng.geometric(0.3, n) * np.where(rng.random(n) < 0.5, -1, 1)
    # the steps in passes, each taking the positions whose previous value
    # is known: as many passes as the longest run of steps
    pending = np.nonzero(val < 0)[0]
    while pending.size:
        prev = np.where(pending > 0, val[pending - 1], 93)
        ok = prev >= 0
        val[pending[ok]] = np.clip(prev[ok] + step[pending[ok]], 0, 93)
        pending = pending[~ok]
    return val.astype(np.uint8).tobytes()


def reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """The BAI bin of [beg, end) (SAM spec 5.3), vectorised."""
    end = end - 1
    out = np.zeros(len(beg), np.int64)
    done = np.zeros(len(beg), bool)
    for shift, first in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        hit = ~done & ((beg >> shift) == (end >> shift))
        out[hit] = first + (beg[hit] >> shift)
        done |= hit
    return out


def bam_record_stream(batch, read_len: int = BAM_READ_LEN,
                      seed: int = 7) -> bytes:
    """Leg 1's records as an uncompressed BAM record stream (SAM spec
    4.2), built in numpy: per record the u32 block size, the 32-byte core
    (reference 0, leg 1's start, mapq, bin, one CIGAR op, leg 1's flag,
    read_len bases, no mate), the name r000000001.., the CIGAR read_len M,
    the first read_len bases of leg 1's packed sequence, and phred
    qualities as bounded random walks: 201 bytes a 100-bp record."""
    cores, seq4, starts, _ends, _valid = batch
    n = len(starts)
    rng = np.random.default_rng(seed)
    l_name = 11                      # "r%09d" and its NUL
    l_seq4 = (read_len + 1) // 2
    body = 32 + l_name + 4 + l_seq4 + read_len
    rec = np.zeros((n, 4 + body), np.uint8)

    def put(col, values, dtype):
        a = np.ascontiguousarray(np.asarray(values).astype(dtype))
        rec[:, col:col + a.itemsize] = a.reshape(n, 1).view(np.uint8)

    put(0, np.full(n, body), "<u4")
    put(4, np.zeros(n), "<i4")                       # refID
    put(8, starts, "<i4")                            # pos
    rec[:, 12] = l_name
    rec[:, 13] = rng.integers(0, 61, n)              # mapq
    put(14, reg2bin(starts.astype(np.int64), starts.astype(np.int64)
                    + read_len), "<u2")
    put(16, np.ones(n), "<u2")                       # n_cigar_op
    put(18, cores[:, 14].astype(np.int64)
        | (cores[:, 15].astype(np.int64) << 8), "<u2")  # flag
    put(20, np.full(n, read_len), "<i4")             # l_seq
    put(24, np.full(n, -1), "<i4")                   # next refID
    put(28, np.full(n, -1), "<i4")                   # next pos
    put(32, np.zeros(n), "<i4")                      # tlen
    rec[:, 36] = ord("r")
    idx = np.arange(1, n + 1)
    for k in range(9):
        rec[:, 37 + k] = ord("0") + (idx // 10 ** (8 - k)) % 10
    at = 36 + l_name
    put(at, np.full(n, read_len << 4), "<u4")       # CIGAR: read_len M
    at += 4
    rec[:, at:at + l_seq4] = seq4[:, :l_seq4]
    at += l_seq4
    rec[:, at:] = np.clip(rng.integers(25, 38, (n, 1))
                          + np.cumsum(rng.integers(-2, 3, (n, read_len)), 1),
                          2, 41)
    return rec.tobytes()


LEG8_REFS = ["chr1", "chrUn_KI270302v1"]


# leg 12's INFO and FORMAT fields, in the layout of a GATK joint-genotyping
# (1000 Genomes style) call set
LEG12_HEADER = [
    "##fileformat=VCFv4.2",
    '##FILTER=<ID=PASS,Description="All filters passed">',
    '##FILTER=<ID=LowQual,Description="Low quality">',
    '##FILTER=<ID=q10,Description="Quality below 10">',
    '##INFO=<ID=DP,Number=1,Type=Integer,Description="Approximate read '
    'depth">',
    '##INFO=<ID=AC,Number=A,Type=Integer,Description="Allele count in '
    'genotypes">',
    '##INFO=<ID=AF,Number=A,Type=Float,Description="Allele frequency">',
    '##INFO=<ID=AN,Number=1,Type=Integer,Description="Total number of '
    'alleles in called genotypes">',
    '##INFO=<ID=DB,Number=0,Type=Flag,Description="dbSNP membership">',
    '##INFO=<ID=CSQ,Number=1,Type=String,Description="Consequence">',
    '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
    '##FORMAT=<ID=AD,Number=R,Type=Integer,Description="Allelic depths">',
    '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Read depth">',
    '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype '
    'quality">',
    '##FORMAT=<ID=PL,Number=G,Type=Integer,Description="Phred-scaled '
    'genotype likelihoods">']
LEG12_CSQ = ["missense", "synonymous", "intron", "UTR3", "stop_gained"]


def leg12_vcf(n: int = N_VCF, samples: int = N_SAMPLES,
              seed: int = 12) -> bytes:
    """Leg 12's VCF text: n sorted records over LEG12_CONTIGS (half on
    each), `samples` samples, the fields of LEG12_HEADER.  10% of the
    records multi-allelic (2-3 ALTs), 5% with a longer REF and 10% of the
    ALTs insertions; 30% with an rs ID and the DB flag; FILTER PASS,
    LowQual or q10 (80/12/8%); 20% of the GTs phased; 2% of the samples
    missing whole, 2% of the AD vectors and QUALs missing."""
    rng = np.random.default_rng(seed)
    head = LEG12_HEADER + [f"##contig=<ID={c},length={ln}>"
                           for c, ln in LEG12_CONTIGS]
    head.append("\t".join(["#CHROM", "POS", "ID", "REF", "ALT", "QUAL",
                           "FILTER", "INFO", "FORMAT"]
                          + [f"S{i}" for i in range(samples)]))
    acgt = "ACGT"
    filters = ["PASS", "LowQual", "q10"]
    lines = []
    for (contig, _), m in zip(LEG12_CONTIGS, (n // 2, n - n // 2)):
        for p in (np.cumsum(rng.integers(1, 2000, m)) + 10_000).tolist():
            n_alt = 1 if rng.random() >= 0.1 else int(rng.integers(2, 4))
            ref = acgt[rng.integers(4)]
            if rng.random() < 0.05:
                ref += "".join(acgt[i] for i in rng.integers(
                    0, 4, rng.integers(1, 6)))
            alts = []
            while len(alts) < n_alt:
                a = acgt[rng.integers(4)]
                if rng.random() < 0.1:
                    a += "".join(acgt[i] for i in rng.integers(
                        0, 4, rng.integers(1, 4)))
                if a != ref and a not in alts:
                    alts.append(a)
            na, db = n_alt + 1, rng.random() < 0.3
            ng = na * (na + 1) // 2
            gts = rng.integers(0, na, (samples, 2))
            sep = np.where(rng.random(samples) < 0.2, "|", "/")
            ad = rng.integers(0, 60, (samples, na))
            dp = ad.sum(1)
            gq = rng.integers(0, 100, samples)
            pl = rng.integers(0, 3000, (samples, ng))
            pl[np.arange(samples), rng.integers(0, ng, samples)] = 0
            gone = rng.random(samples) < 0.02
            no_ad = rng.random(samples) < 0.02
            ad_s = [",".join(map(str, r)) for r in ad.tolist()]
            pl_s = [",".join(map(str, r)) for r in pl.tolist()]
            cols = ["./.:.:.:.:." if gone[s] else
                    f"{gts[s, 0]}{sep[s]}{gts[s, 1]}:"
                    f"{'.' if no_ad[s] else ad_s[s]}:{dp[s]}:{gq[s]}:"
                    f"{pl_s[s]}" for s in range(samples)]
            ac = [int((gts[~gone] == k + 1).sum()) for k in range(n_alt)]
            an = 2 * int((~gone).sum())
            info = [f"DP={int(dp[~gone].sum())}",
                    "AC=" + ",".join(map(str, ac)),
                    "AF=" + ",".join(f"{a / max(an, 1):.3f}" for a in ac),
                    f"AN={an}"] + (["DB"] if db else []) + [
                    "CSQ=" + LEG12_CSQ[int(rng.integers(len(LEG12_CSQ)))]]
            lines.append("\t".join([
                contig, str(p),
                f"rs{int(rng.integers(1, 10**9))}" if db else ".",
                ref, ",".join(alts),
                f"{rng.random() * 5000:.2f}" if rng.random() >= 0.02
                else ".",
                filters[int(rng.choice(3, p=[0.8, 0.12, 0.08]))],
                ";".join(info), "GT:AD:DP:GQ:PL"] + cols))
    return ("\n".join(head) + "\n" + "\n".join(lines) + "\n").encode()


def varied_bam_stream(n: int = 50_000, seed: int = 9,
                      pos_span: int = 250_000_000):
    """Leg 8's varied BAM record stream, built with the port's record
    model: n records on LEG8_REFS, starting below `pos_span`, paired (mates on the same reference,
    "=", on the other, or none; negative TLENs), 1-8 CIGAR ops of
    M/I/D/N/S/=/X around the query, 2% unmapped (every "*" field), a few
    with no quality (0xFF) and a few with an empty SEQ, and aligner-style
    aux tags (NM:i, MD:Z, AS:i, XS:i, RG:Z) with some f and d values and B
    arrays of f, s and C (the %g boundary).  Returns the u32-framed
    payload."""
    from htslib_tpu_torch.sam.record import BamRecord, encode_aux
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        b = BamRecord()
        b.qname = b"q%d:%s" % (i, b"x" * int(rng.integers(0, 24)))
        unmapped = rng.random() < 0.02
        paired = rng.random() < 0.7
        ops = []
        if not unmapped:
            k = int(rng.integers(1, 9))
            codes = rng.choice([0, 0, 0, 1, 2, 3, 4, 7, 8], k)
            codes[0] = rng.choice([0, 4, 7])
            codes[-1] = rng.choice([0, 4, 8])
            ops = [(int(rng.integers(1, 60)) << 4) | int(c) for c in codes]
        qlen = sum(int(c) >> 4 for c in ops if (int(c) & 15) in (0, 1, 4, 7,
                                                                 8))
        if unmapped:
            qlen = int(rng.integers(20, 120))
        b.cigar = np.array(ops, np.uint32)
        b.flag = (4 if unmapped else 0) | (1 if paired else 0) | int(
            rng.choice([0, 16, 256, 1024, 2048]))
        b.tid = -1 if unmapped else int(rng.integers(0, 2))
        b.pos = -1 if unmapped else int(rng.integers(0, pos_span))
        b.mapq = 0 if unmapped else int(rng.integers(0, 61))
        if paired:
            b.mtid = int(rng.choice([b.tid, 0, 1, -1]))
            b.mpos = -1 if b.mtid < 0 else int(rng.integers(0, 1 << 28))
            b.isize = int(rng.integers(-800, 800))
        empty_seq = rng.random() < 0.01
        if empty_seq or qlen == 0:
            b.set_seq("*")
        else:
            b.set_seq("".join(rng.choice(list("ACGTN"), qlen)))
            if rng.random() > 0.01:
                b.qual = rng.integers(2, 42, qlen, dtype=np.uint8).tobytes()
        aux = b""
        if not unmapped:
            aux += encode_aux(b"NM", "i", int(rng.integers(0, 9)))
            aux += encode_aux(b"MD", "Z", "%dA%d" % (rng.integers(0, 50),
                                                     rng.integers(0, 50)))
            aux += encode_aux(b"AS", "i", int(rng.integers(-10, 150)))
            if rng.random() < 0.5:
                aux += encode_aux(b"XS", "i", int(rng.integers(0, 70000)))
        if rng.random() < 0.8:
            aux += encode_aux(b"RG", "Z", "grp%d" % rng.integers(0, 3))
        if rng.random() < 0.1:
            aux += encode_aux(b"XF", "f", float(rng.normal() * 10 ** int(
                rng.integers(-8, 8))))
        if rng.random() < 0.03:
            aux += encode_aux(b"XD", "d", float(rng.exponential(1e5)))
        if rng.random() < 0.05:
            sub = str(rng.choice(["f", "s", "C"]))
            vals = (rng.normal(size=int(rng.integers(0, 6))) * 100
                    if sub == "f" else rng.integers(0, 200, int(
                        rng.integers(1, 6))))
            aux += encode_aux(b"ZB", "B", (sub, vals))
        b.aux = aux
        body = b.to_bam_buffer()
        out.append(struct.pack("<I", len(body)) + body)
    return b"".join(out)


def hmm_reads(n: int, length: int, seed: int):
    """n reads of `length` bases, about as leg 9's: 1% substitutions, a
    1-12 bp deletion in one read of 20, each its reference window and band
    as realn sets them.  Returns pad_batch's (refs, queries, quals,
    bws)."""
    rng = np.random.default_rng(seed)
    refs, qs, quals, bws = [], [], [], []
    for k in range(n):
        ref = rng.integers(0, 4, length + 40).astype(np.uint8)
        q = ref[10:10 + length].copy()
        diff = 0
        if k % 20 == 0:
            at, m = int(rng.integers(5, length - 5)), int(rng.integers(1, 13))
            q = np.concatenate([q[:at], ref[10 + at + m:10 + length + m]])
            diff = m
        sub = rng.random(length) < 0.01
        q[sub] = rng.integers(0, 4, int(sub.sum()))
        bw = 7 if diff <= 7 else diff + 3
        refs.append(ref[10 - bw // 2:10 + length + diff + bw // 2].tobytes())
        qs.append(q[:length].tobytes())
        quals.append(np.clip(rng.integers(25, 38) + np.cumsum(
            rng.integers(-2, 3, length)), 2, 41).astype(np.uint8).tobytes())
        bws.append(bw)
    return refs, qs, quals, bws


def baq_case(n: int = 100_000, seed: int = 10, ref_len: int = 1_000_000,
             n_long: int = 200, read_len: int = BAM_READ_LEN):
    """Leg 9's BAQ input: a seeded reference of ref_len bases (ACGT with a
    few N runs) and n mapped-looking records sampled from it: read_len bp
    (n_long of them 1,200-2,000 bp, the d = 1e-7 group), 1% substitutions
    and qualities as leg 7's walks; 5% with one 1-12 bp insertion or
    deletion (bands up to 15), 3% soft-clipped, 1% unmapped, and 1% with
    BQ or ZQ tags that reach sam_prob_realn's tag exits (a BQ of the
    read's length, one a base short, a ZQ, a ZQ a base short, both).
    Returns (reference str, records)."""
    from htslib_tpu_torch.sam.record import BamRecord
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    ref = rng.choice(acgt, ref_len)
    for _ in range(max(1, ref_len // 200_000)):
        at = int(rng.integers(0, ref_len - 200))
        ref[at:at + int(rng.integers(5, 150))] = ord("N")
    long_at = set(rng.choice(n, min(n_long, n), replace=False).tolist())
    recs = []
    for i in range(n):
        L = int(rng.integers(1200, 2001)) if i in long_at else read_len
        b = BamRecord()
        b.qname = b"baq%d" % i
        kind = rng.random()
        pos = int(rng.integers(0, ref_len - L - 40))
        seg = ref[pos:pos + L + 20].copy()
        if kind < 0.01:                                   # unmapped
            q, ops = seg[:L], []
        elif kind < 0.035:                                # insertion
            k = int(rng.integers(1, 13))
            a = int(rng.integers(10, L - k - 10))
            q = np.concatenate([seg[:a], rng.choice(acgt, k),
                                seg[a:L - k]])
            ops = [(a, 0), (k, 1), (L - k - a, 0)]
        elif kind < 0.06:                                 # deletion
            k = int(rng.integers(1, 13))
            a = int(rng.integers(10, L - 10))
            q = np.concatenate([seg[:a], seg[a + k:L + k]])
            ops = [(a, 0), (k, 2), (L - a, 0)]
        elif kind < 0.09:                                 # soft clip
            c = int(rng.integers(3, 20))
            q = np.concatenate([rng.choice(acgt, c), seg[:L - c]])
            ops = [(c, 4), (L - c, 0)]
        else:
            q, ops = seg[:L], [(L, 0)]
        q = q.copy()
        sub = rng.random(L) < 0.01
        q[sub] = rng.choice(acgt, int(sub.sum()))
        b.set_seq(q.tobytes().decode())
        b.qual = np.clip(rng.integers(25, 38) + np.cumsum(
            rng.integers(-2, 3, L)), 2, 41).astype(np.uint8).tobytes()
        if ops:
            b.tid, b.pos, b.flag, b.mapq = 0, pos, 0, 60
            b.cigar = np.array([(ln << 4) | op for ln, op in ops], np.uint32)
        if rng.random() < 0.01:
            tag = int(rng.integers(0, 5))
            txt = rng.integers(64, 90, L, dtype=np.uint8).tobytes()
            if tag in (0, 4):
                b.set_aux("BQ", "Z", txt)
            if tag == 1:
                b.set_aux("BQ", "Z", txt[:-1])
            if tag in (2, 4):
                b.set_aux("ZQ", "Z", txt)
            if tag == 3:
                b.set_aux("ZQ", "Z", txt[:-1])
        recs.append(b)
    return ref.tobytes().decode(), recs


def scan_streams(good: bytes, n_good: int, big: bytes, n_big: int):
    """name -> (payload, max_records): record streams at X5's edges, made
    from a well-framed stream `good` of n_good records and a larger one
    `big` of n_big: each whole, with max_records short and long of the
    count, truncated, a length with bit 31 set (the chain moves back), a
    length of -4 (the chain stands still), a length that overruns the
    payload, a first length that jumps 700,000 bytes (past the kernel's
    next window), payloads under 4 bytes and of one empty record, and
    max_records 0."""
    neg = bytearray(good[:400])
    neg[0:4] = (0x80000010).to_bytes(4, "little")
    stuck = bytearray(good[:64])
    stuck[0:4] = (0xFFFFFFFC).to_bytes(4, "little")
    over = bytearray(good)
    over[-300:-296] = (10 ** 6).to_bytes(4, "little")
    jump = bytearray(big)
    jump[0:4] = (700_000).to_bytes(4, "little")
    return {"varied": (good, n_good), "varied_short": (good, n_good // 17),
            "varied_long": (good, n_good + 33), "big": (big, n_big),
            "truncated": (good[:-5], n_good), "bit31": (bytes(neg), 50),
            "stuck": (bytes(stuck), 40), "overrun": (bytes(over), n_good),
            "jump": (bytes(jump), n_big), "tiny": (b"\x01\x00", 3),
            "empty4": (b"\x00" * 4, 5), "none": (good, 0)}


def record_starts(stream: bytes) -> list:
    """The offsets of the records of a well-framed BAM record stream."""
    out, pos = [], 0
    while pos + 4 <= len(stream):
        out.append(pos)
        pos += 4 + int.from_bytes(stream[pos:pos + 4], "little")
    return out


def false_guesses(stream: bytes, seg_bytes: int, limit: int = 1 << 30
                  ) -> bytes:
    """The stream with a crafted record header at the start of each
    segment (of seg_bytes) that a record crosses with 37 bytes or more
    left, at most `limit` of them: a block_size that ends the false record
    where the true next one starts, a read name of one NUL, no CIGAR or
    SEQ.  The chain looks like BAM records from there, so a segment's
    guess of its entry is the false position; the true chain passes it by
    inside the crossing record."""
    out = bytearray(stream)
    starts = record_starts(stream)
    is_start = set(starts)
    nxt = iter(starts[1:] + [len(stream)])
    a, q = 0, next(nxt)
    done = 0
    for lo in range(seg_bytes, len(stream), seg_bytes):
        while q <= lo:
            a, q = q, next(nxt)
        # the crossing record's body holds [lo, lo + 37), not its length
        if (q - lo >= 37 and lo >= a + 4 and done < limit
                and lo not in is_start):
            fake = struct.pack("<iiiBBHHHiiii", q - lo - 4, 0, 0, 1, 0, 0,
                               0, 0, 0, -1, -1, 0) + b"\0"
            out[lo:lo + len(fake)] = fake
            done += 1
    return bytes(out)


def seg_edge_streams(good: bytes, n_good: int, seg_bytes: int):
    """name -> (payload, max_records): record streams at the edges of
    kernel X5's segmented walk, for segments of seg_bytes, made from the
    well-framed stream `good` of n_good records: crafted false entries
    (`false_guesses`, a few and one at every segment), a record longer
    than three segments, a negative length, a length of -4 and a length
    that wraps the int32 sum, each in the middle of a segment,
    max_records in the middle of a segment, payloads of 0 to 4 bytes, and
    one whose length is not a multiple of 16."""
    starts = record_starts(good)

    def mid(frac):
        """A record start near `frac` of the stream, not on a segment's
        first 16 bytes."""
        i = int(len(starts) * frac)
        while starts[i] % seg_bytes < 16:
            i += 1
        return starts[i]

    def with_len(at, v):
        b = bytearray(good)
        b[at:at + 4] = (v & 0xFFFFFFFF).to_bytes(4, "little")
        return bytes(b)

    at = mid(0.5)
    big = 3 * seg_bytes + 100
    long_rec = (good[:at] + big.to_bytes(4, "little")
                + bytes(range(256)) * (big // 256) + bytes(big % 256)
                + good[at:])
    return {
        "false_few": (false_guesses(good, seg_bytes, 3), n_good),
        "false_all": (false_guesses(good, seg_bytes), n_good + 7),
        "long_record": (long_rec, n_good + 1),
        "neg_mid": (with_len(at, -1000), n_good),
        "minus4_mid": (with_len(at, -4), n_good),
        "wrap_mid": (with_len(mid(0.6), 0x7FFFFFF0), n_good),
        "max_mid": (good, starts.index(mid(0.4)) + 1),
        "u0": (b"", 3), "u1": (good[:1], 3), "u2": (good[:2], 3),
        "u3": (good[:3], 3), "u4": (good[:4], 3),
        "u_odd": (good[:len(good) - (5 if (len(good) - 5) % 16 else 6)],
                  n_good),
    }


def deflate_raw(data: bytes, level: int = BGZF_LEVEL,
                strategy: int = zlib.Z_DEFAULT_STRATEGY) -> bytes:
    """A raw DEFLATE stream (no zlib header), as a BGZF member holds."""
    co = zlib.compressobj(level, zlib.DEFLATED, -15, 8, strategy)
    return co.compress(data) + co.flush()


def bgzf_members(stream: bytes, block: int = BGZF_BLOCK):
    """The stream cut into BGZF-sized pieces, each deflated on the host at
    bgzip's default level, in threads (zlib releases the interpreter
    lock): (payloads, raw pieces)."""
    raws = [stream[i:i + block] for i in range(0, len(stream), block)]
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as tp:
        return list(tp.map(deflate_raw, raws)), raws


def _fixed(w, sym: int):
    """A literal/length symbol of the fixed code (RFC 1951 3.2.6) onto
    bit writer w (the port's `bgzf_device._BitWriter`)."""
    if sym < 144:
        w.put_code(0x30 + sym, 8)
    elif sym < 256:
        w.put_code(0x190 + sym - 144, 9)
    elif sym < 280:
        w.put_code(sym - 256, 7)
    else:
        w.put_code(0xC0 + sym - 280, 8)


def _fixed_block(items, final: bool = True):
    """One fixed-code block: items are literal bytes (ints) or (length
    symbol, distance symbol) pairs with no extra bits; then EOB."""
    from htslib_tpu_torch.ops.bgzf_device import _BitWriter
    w = _BitWriter()
    w.put(int(final), 1)
    w.put(1, 2)
    for it in items:
        if isinstance(it, tuple):
            _fixed(w, it[0])
            w.put_code(it[1], 5)
        else:
            _fixed(w, it)
    _fixed(w, 256)
    return w


def inflate_members(seed: int = 8):
    """Small members for holding kernel X4 against its plain version and
    zlib: (name, payload, ISIZE, expected bytes or None where the JAX
    function refuses the member; a refused member's ISIZE is what it
    would give were it accepted).  zlib streams: stored, fixed, dynamic,
    long matches, multi-block (full flushes between parts), level 1 and
    empty; hand-built ones at the JAX decoder's edges: distance code 30
    (one 0xFF byte), a match reaching before the output's start, one
    copying position 0 from itself, 600 empty fixed blocks (the step
    cap), stored blocks reaching past the payload (final: zeros; not
    final: a step begins past the end), block type 3, a corrupt first
    byte and a wrong ISIZE."""
    from htslib_tpu_torch.ops.bgzf_device import _BitWriter

    def tobytes(w):
        return w.tobytes_and_len()[0]

    def align(w):
        w.put(0, -len(w.bits) % 8)

    rng = np.random.default_rng(seed)
    walk = np.clip(np.cumsum(rng.integers(-2, 3, 3000)) + 30, 2, 41)
    text = b"the quick brown fox jumps over the lazy dog " * 70
    mixed = (b"ACGT" * 500) + rng.integers(0, 256, 2000,
                                           dtype=np.uint8).tobytes()
    rand = rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
    out = [("stored", deflate_raw(rand, 0), rand),
           ("fixed", deflate_raw(text, 6, zlib.Z_FIXED), text),
           ("dynamic", deflate_raw(walk.astype(np.uint8).tobytes()),
            walk.astype(np.uint8).tobytes()),
           ("long_matches", deflate_raw(b"A" * 20000, 9), b"A" * 20000),
           ("level1", deflate_raw(mixed, 1), mixed),
           ("empty", deflate_raw(b""), b"")]
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    parts = [text[:800], rand[:800], walk.astype(np.uint8).tobytes()[:800],
             mixed[:800]]
    multi = b"".join(co.compress(x) + co.flush(zlib.Z_FULL_FLUSH)
                     for x in parts) + co.flush()
    out.append(("multi_block", multi, b"".join(parts)))
    out.append(("dist_code_30", tobytes(_fixed_block([97, (257, 30)])),
                b"a\xff"))
    out.append(("match_before_start", tobytes(_fixed_block([98, (257, 4)])),
                b"bbbb"))
    out.append(("match_at_start", tobytes(_fixed_block([(257, 0), 99])),
                b"\x00\x00\x00c"))
    w = _BitWriter()
    for _ in range(600):
        w.put(0, 1)
        w.put(1, 2)
        _fixed(w, 256)
    w.bits += _fixed_block([122]).bits
    out.append(("step_cap", tobytes(w), 1))
    for final in (1, 0):
        w = _BitWriter()
        w.put(final, 1)
        w.put(0, 2)
        align(w)
        w.put(100, 16)
        w.put(0xFFFF ^ 100, 16)
        pl = tobytes(w) + rand[:50]
        out.append((f"stored_past_end_{'final' if final else 'more'}",
                    pl, rand[:50] + bytes(50) if final else 100))
    w = _BitWriter()
    w.put(1, 1)
    w.put(3, 2)
    out.append(("btype_3", tobytes(w), 0))
    good = deflate_raw(b"hello world" * 50)
    out += [("corrupt", bytes([good[0] ^ 0xFF]) + good[1:], 550),
            ("wrong_isize", good, 551)]
    # an int in place of the bytes: a refused member's ISIZE
    return [(name, pl, want, None) if isinstance(want, int)
            else (name, pl, len(want), want) for name, pl, want in out]


def _fixed_match(w, length: int, dist: int):
    """A match of the fixed code onto bit writer w, with its extra bits."""
    from htslib_tpu_torch.ops.inflate import (DIST_BASE, DIST_EXTRA,
                                              LENGTH_BASE, LENGTH_EXTRA)
    lc = 28 if length == 258 else max(
        c for c in range(28) if LENGTH_BASE[c] <= length)
    dc = max(c for c in range(30) if DIST_BASE[c] <= dist)
    _fixed(w, 257 + lc)
    w.put(length - LENGTH_BASE[lc], LENGTH_EXTRA[lc])
    w.put_code(dc, 5)
    w.put(dist - DIST_BASE[dc], DIST_EXTRA[dc])


def _stored(data: bytes, final: bool = False) -> bytes:
    """A stored block that starts on a byte boundary."""
    n = len(data)
    return bytes([int(final)]) + struct.pack("<HH", n, 0xFFFF ^ n) + data


def _copy(out: bytearray, length: int, dist: int) -> None:
    """The JAX decoder's match: each byte q reads byte max(q - dist, 0),
    byte 0 copying itself reads dist - 1."""
    for _ in range(length):
        q = len(out)
        out.append((dist - 1) & 0xFF if q == 0
                   else out[q - dist if q >= dist else 0])


def ring_edge_members(seed: int = 14):
    """Members at the edges of X4's 32 KiB output ring, in
    inflate_members()'s form: stored blocks then one fixed-code block of
    matches with their extra bits (few steps, so the JAX function and the
    plain version take them at once).  dist_32768: 32,768 stored bytes
    copied again at distance 32,768, 65,536 bytes; wrap_long_matches:
    random long matches over the ring's wraps up to 65,536 bytes;
    stored_blocks: stored blocks of 10,000, 35,000 and 12,000 bytes (one
    past the ring) read back at distances up to 32,768; clamp_at_wrap: a
    match reaching before the output's start that crosses position
    32,768; cap_in_match: 70,186 bytes whose 64 KiB capacity ends inside
    a match (the JAX function gives the first 65,536)."""
    from htslib_tpu_torch.ops.bgzf_device import _BitWriter
    rng = np.random.default_rng(seed)

    def rand(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    def member(name, blocks, matches, size=None, tail=b""):
        out = bytearray(b"".join(blocks))
        w = _BitWriter()
        w.put(1, 1)
        w.put(1, 2)
        for length, dist in matches:
            _fixed_match(w, length, dist)
            _copy(out, length, dist)
        for b in tail:
            _fixed(w, b)
            out.append(b)
        _fixed(w, 256)
        pl = b"".join(_stored(b) for b in blocks) + w.tobytes_and_len()[0]
        isize = len(out) if size is None else size
        return name, pl, isize, bytes(out[:min(isize, 65536)])

    res = [member("dist_32768", [rand(32768)], [(258, 32768)] * 127,
                  tail=b"zz")]
    pos, matches = 30000, []
    while pos < 65536 - 258:
        m = (int(rng.integers(3, 259)),
             int(rng.integers(1, min(pos, 32768) + 1)))
        matches.append(m)
        pos += m[0]
    res.append(member("wrap_long_matches", [rand(20000), rand(10000)],
                      matches, tail=rand(65536 - pos)))
    res.append(member("stored_blocks",
                      [rand(10000), rand(35000), rand(12000)],
                      [(258, 32768), (200, 20000), (258, 1), (100, 32000)]
                      * 10))
    res.append(member("clamp_at_wrap", [rand(32700)], [(258, 32768)] * 2))
    res.append(member("cap_in_match", [rand(40000)], [(258, 30000)] * 117))
    return res


def wide_stream(rng, size: int) -> bytes:
    """Every other byte 0 and then a random one: order-1 context 0 has
    ~256 successors of frequency ~16, so a 64-slot bucket of its table
    holds several row starts: a slow bucket, whose lookups B5/B6 take
    through its map and B8 through its walk."""
    d = np.zeros(size, np.uint8)
    d[1::2] = rng.integers(0, 256, size // 2)
    return d.tobytes()


def enc_edge_streams(seed: int = 31):
    """B9's edge cases: lengths 1, 31, 32 and 33 (the all-live rounds and
    the last round's predicate), one-symbol streams (f = 4096, whose
    threshold f << 19 is 2^31), a stream whose rare symbols have f = 1
    (the reciprocal's bias case), and lengths about the kernel's 32-round
    window (1,023, 1,024, 2,049 and 3,000 symbols)."""
    rng = np.random.default_rng(seed)
    rare = np.full(20000, 40, np.uint8)
    rare[rng.choice(20000, 30, replace=False)] = np.arange(30, dtype=np.uint8)
    return [rng.integers(0, 40, n, dtype=np.uint8).tobytes()
            for n in (1, 31, 32, 33, 1023, 1024, 2049, 3000)] + [
        bytes([7]) * 5000, bytes([200]) * 33, rare.tobytes()]


def fallback_buckets(tables) -> int:
    """(context, 64-slot bucket) pairs of stream 0's order-1 table in
    which two or more rows start after the bucket's first slot: the
    buckets whose lookups can reach the loop."""
    n = int(tables.n_rows[0])
    rows = tables.rows.cpu().numpy().view(np.uint32)[:n].astype(np.int64)
    cs = tables.ctx_start[0].cpu().numpy()
    ctx = np.repeat(np.arange(256), np.diff(cs))
    cum = (rows >> 12) & 0xFFF
    inside = cum & 63 != 0
    _, counts = np.unique(ctx[inside] * 64 + (cum[inside] >> 6),
                          return_counts=True)
    return int((counts >= 2).sum())


def nt16_numpy(seq4: np.ndarray) -> np.ndarray:
    lut = np.frombuffer(b"=ACMGRSVTWYHKDBN", np.uint8)
    out = np.empty((seq4.shape[0], 2 * seq4.shape[1]), np.uint8)
    out[:, 0::2] = lut[seq4 >> 4]
    out[:, 1::2] = lut[seq4 & 15]
    return out


def coverage_numpy(starts, ends, tile_len):
    diff = np.zeros(tile_len + 1, np.int64)
    np.add.at(diff, np.clip(starts, 0, tile_len), 1)
    np.add.at(diff, np.clip(ends, 0, tile_len), -1)
    return np.cumsum(diff[:-1])


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"mismatch: {what}")


def hist_of(raw: bytes, qbins: int) -> np.ndarray:
    return np.bincount(np.minimum(np.frombuffer(raw, np.uint8), qbins - 1),
                       minlength=qbins)


def main_path(device, batch, raws, encs, leg3, bgzf, varied, baq,
              tile_len=TILE_LEN, n_decode=N_DECODE):
    """Phases 3-5n through the port's entry points on `device`, each
    result held against its host truth.  Returns (leg-1 args on the
    device, seconds of each phase, notes: leg 4's timing dict, leg 5's
    lookups per second, legs 6-16's parts)."""
    from htslib_tpu_torch.entry import entry
    from htslib_tpu_torch.ops.device_stats import (QBINS, cram_qual_hist,
                                                   qualstats_device,
                                                   qualstats_device_4x8,
                                                   qualstats_device_o1)
    from htslib_tpu_torch.ops.huffman import make_huffman_resolve_bench
    from htslib_tpu_torch.ops.pileup_kernel import coverage_tile
    from htslib_tpu_torch.ops.rans4x8 import decode_4x8_o0_batch
    from htslib_tpu_torch.ops.rans_enc import encode_nx16_o0_batch
    from htslib_tpu_torch.ops.rans_nx16 import (decode_nx16_o0_batch,
                                                make_resolve_bench)
    from htslib_tpu_torch.ops.rans_nx16_o1 import decode_nx16_o1_batch
    from htslib_tpu_torch.ops.seqfmt import nibble_to_base, unpack_core_fields

    cores, seq4, starts, ends, _valid = batch
    flags_np = cores[:, 14].astype(np.int64) | (cores[:, 15].astype(np.int64)
                                                << 8)
    bases_np = nt16_numpy(seq4)
    cov_np = coverage_numpy(starts, ends, tile_len)
    fixture_want = []
    for path in FIXTURES:
        with open(path + ".hist.json") as fp:
            fixture_want.append(json.load(fp))
    secs = {}

    t0 = time.time()
    forward, args = entry(device=device, tile_len=tile_len, batch=batch)
    total = int(forward(*args))
    want = (int(flags_np.sum()) + int(bases_np.sum(dtype=np.int64))
            + int(cov_np.sum()) + (1 << 31)) % (1 << 32) - (1 << 31)
    require(total == want, f"leg 1 total {total} != {want}")
    require(int(unpack_core_fields(args[0])["flag"].sum())
            == int(flags_np.sum()), "leg 1 flag sum")
    require(np.array_equal(nibble_to_base(args[1]).cpu().numpy(), bases_np),
            "leg 1 nibble_to_base bytes")
    cov = coverage_tile(args[2], args[3], args[4], 0, tile_len)
    require(np.array_equal(cov.cpu().numpy(), cov_np), "leg 1 coverage")
    secs["leg1"] = time.time() - t0

    # leg 2, its parts timed apart: the histogram call (its framing and
    # transfer, then its launch and download, `decode_s`), the checks
    # against the raw streams, and the decode call with its check
    t0 = time.time()
    hist, timing = qualstats_device(encs, device=device)
    t1 = time.time()
    for i, raw in enumerate(raws):
        require(np.array_equal(hist[i], hist_of(raw, QBINS)),
                f"leg 2 histogram of stream {i}")
    t2 = time.time()
    out = decode_nx16_o0_batch(encs[:n_decode], device=device)
    t3 = time.time()
    require(out == raws[:n_decode], "leg 2 decoded bytes")
    secs["leg2"] = time.time() - t0
    leg2 = {"hist_call_s": t1 - t0, "hist_launch_download_s":
            timing["decode_s"], "hist_framing_s": t1 - t0
            - timing["decode_s"], "hist_checks_s": t2 - t1,
            "decode_call_s": t3 - t2, "decode_check_s": time.time() - t3}

    t0 = time.time()
    for wire, run in (
            ("nx16_o1", lambda e: qualstats_device_o1(e, device=device)),
            ("4x8_o0", lambda e: qualstats_device_4x8(e, device=device)),
            ("4x8_o1", lambda e: qualstats_device_4x8(e, device=device,
                                                      o1=True))):
        w_raws, w_encs = leg3[wire][:2]
        hist, _ = run(w_encs)
        for i, raw in enumerate(w_raws):
            require(np.array_equal(hist[i], hist_of(raw, QBINS)),
                    f"leg 3 {wire} histogram of stream {i}")
    for wire, dec in (("nx16_o1", decode_nx16_o1_batch),
                      ("4x8_o0", decode_4x8_o0_batch)):
        w_raws, w_encs = leg3[wire][:2]
        require(dec(w_encs[:n_decode], device=device) == w_raws[:n_decode],
                f"leg 3 {wire} decoded bytes")
    secs["leg3"] = time.time() - t0

    t0 = time.time()
    for path, want in zip(FIXTURES, fixture_want):
        stats = {}
        fh = cram_qual_hist(path, device=device, stats=stats)
        name = os.path.basename(path)
        require(fh.tolist() == want["hist"], f"{name} histogram")
        require(stats["device_blocks"] > 0, f"{name} device blocks {stats}")
        require(stats == {"device_blocks": want["device_blocks"],
                          "host_blocks": want["host_blocks"]},
                f"{name} stats {stats}")
    secs["file"] = time.time() - t0

    t0 = time.time()
    enc_timing = {}
    out = encode_nx16_o0_batch(raws, device=device, timing=enc_timing)
    for i, (got, want) in enumerate(zip(out, encs)):
        require(got == want, f"leg 4 device encoding of stream {i}")
    require(len(out) == len(encs), "leg 4 stream count")
    require(decode_nx16_o0_batch(out[:n_decode], device=device)
            == raws[:n_decode], "leg 4 round trip through B2")
    secs["leg4"] = time.time() - t0
    notes = {"leg4_timing": enc_timing, "leg2": leg2}

    t0 = time.time()
    fn, fargs, ref_chain = make_resolve_bench(G=CHAINS, rounds=CHAIN_ROUNDS,
                                              device=device)
    t1 = time.time()
    got = fn(*fargs).cpu().numpy()
    notes["rans_resolve_lookups_per_s"] = CHAINS * CHAIN_ROUNDS / (
        time.time() - t1)
    require(np.array_equal(got, ref_chain().view(np.int32)),
            "leg 5 rANS resolve chain")
    fn, fargs, ref_step, v0 = make_huffman_resolve_bench(
        L=CHAINS, rounds=CHAIN_ROUNDS, device=device)
    t1 = time.time()
    got = fn(*fargs).cpu().numpy()
    notes["huffman_resolve_lookups_per_s"] = CHAINS * CHAIN_ROUNDS / (
        time.time() - t1)
    v = v0[0]
    for _ in range(CHAIN_ROUNDS):
        v, _sym = ref_step(v)
    require(np.array_equal(got, np.broadcast_to(v, got.shape)),
            "leg 5 Huffman resolve chain")
    secs["leg5"] = time.time() - t0

    t0 = time.time()
    notes["leg6"] = leg6(device, raws, encs, leg3, n_decode)
    secs["leg6"] = time.time() - t0

    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="leg11_12_")
    leg10_bam = os.path.join(tmp, "leg10.bam")
    try:
        for leg, run in (("leg7", lambda: leg7(device, bgzf, raws)),
                         ("leg8", lambda: leg8(device, inflated, varied)),
                         ("leg9", lambda: leg9(device, baq)),
                         ("leg11", lambda: leg11(device, tmp)),
                         ("leg12", lambda: leg12(device, tmp)),
                         ("leg13", lambda: leg13(device, tmp,
                                                 notes["leg11"])),
                         ("leg10a", lambda: leg10a(batch)),
                         ("leg10b", lambda: leg10b(device, batch, bgzf,
                                                   chain_sam, cram_plan,
                                                   bcf_plan, leg10_bam)),
                         ("leg14", lambda: leg14(device, tmp, leg10_bam,
                                                 notes["leg11"],
                                                 notes["leg12"])),
                         ("leg15", lambda: leg15(device, tmp, leg10_bam,
                                                 chain_sam, varied_sam,
                                                 notes["leg11"],
                                                 notes["leg12"])),
                         ("leg16", lambda: leg16(device, tmp)),
                         ("leg17", lambda: leg17(
                             device, tmp, notes["leg11"], l14_lines, raws,
                             encs, leg17_files(tmp, leg10_bam,
                                               notes["leg11"],
                                               notes["leg12"])))):
            t0 = time.time()
            with Shapes() as shapes:
                notes[leg], notes["launches_" + leg] = _counted(run)
            notes["shapes_" + leg] = shapes.got
            secs[leg] = time.time() - t0
            if leg == "leg7":
                inflated = notes["leg7"].pop("inflated")
            if leg == "leg8":
                chain_sam = notes["leg8"].pop("chain_sam")
                varied_sam = notes["leg8"].pop("varied_sam")
            if leg == "leg11":
                cram_plan = notes["leg11"].pop("plan")
            if leg == "leg12":
                bcf_plan = notes["leg12"].pop("plan")
            if leg == "leg14":
                l14_lines = notes["leg14"].pop("14c_lines")
        # leg 10b's kernels ran in its rank processes: their counts, with
        # those of 11a's and 12b's shard decodes apart
        notes["launches_leg10b"] = notes["leg10b"].pop("rank_launches")
        notes["launches_leg11_ranks"] = notes["leg10b"].pop(
            "rank_cram_launches")
        notes["launches_leg12_ranks"] = notes["leg10b"].pop(
            "rank_bcf_launches")
        outs = notes["leg10b"].pop("outs")
        # the host truths of legs 11 and 12 in one pool of processes
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                                 mp_context=ctx) as pool:
            notes["leg11"]["check"] = leg11_check(device, notes["leg11"],
                                                  outs, pool)
            texts_11a = notes["leg11"]["check"].pop("texts_11a")
            # 17d's stream, decoded on the card, against the host chain's
            require(notes["leg11"]["check"].pop("blob_11a")
                    == notes["leg17"].pop("blob_17d"),
                    "leg 17d: the stream on the card != the host decode's")
            notes["leg13"]["check"] = leg13_check(
                notes["leg13"], notes["leg11"], texts_11a, pool)
            notes["leg12"]["check"] = leg12_check(notes["leg12"], outs,
                                                  pool)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return args, secs, notes


def leg6(device, raws, encs, leg3, n_decode: int = N_DECODE) -> dict:
    """Leg 6, whole-stream rANS batches through ops/rans.py, every output
    held to its raw bytes; returns its parts (wall_s, each call's seconds
    and `timing` groups, the HiFi blocks' rows, the spill calls')."""
    # each call's streams interleaved across their wires, so every
    # group's outputs must land back in the input order; each launch
    # group's framing (the dense tables' build within it) and decode, and
    # the routing parse, timed
    from htslib_tpu_torch.ops.rans import (uncompress_batch,
                                           uncompress_nx16_batch)
    t0 = time.time()
    groups_4x8, groups_nx16 = {}, {}
    pairs = _interleave([list(zip(*leg3[w][:2])) for w in (
        "4x8_o0", "4x8_o1", "4x8_o1_dense", "4x8_o1_hifi")])
    out = uncompress_batch([e for _, e in pairs], device=device,
                           timing=groups_4x8)
    require(out == [r for r, _ in pairs], "leg 6 uncompress_batch bytes")
    t1 = time.time()
    pairs = _interleave([
        list(zip(raws, encs))[:n_decode],
        list(zip(*leg3["nx16_o1"][:2]))[:n_decode],
        list(zip(*leg3["nx16_4way_o0"][:2]))[:n_decode],
        list(zip(*leg3["nx16_4way_o1"][:2]))[:n_decode],
        list(zip(*leg3["nx16_o1_dense"][:2])),
        list(zip(*leg3["nx16_4way_o1_dense"][:2])),
        list(zip(*leg3["nx16_o1_hifi"][:2])),
        list(zip(*leg3["nx16_4way_o1_hifi"][:2]))])
    out = uncompress_nx16_batch([e for _, e in pairs], device=device,
                                timing=groups_nx16)
    require(out == [r for r, _ in pairs], "leg 6 uncompress_nx16_batch bytes")
    # each wire's spill stream repeated one stream past LARGE_WAVES waves
    # of the large variant, so that its group goes to the dense variant
    t2 = time.time()
    copies = spill_copies(device, leg3)
    spill_4x8, spill_nx16 = {}, {}
    raw, enc = leg3["4x8_o1_spill"]
    n = copies["4x8_o1"]
    require(uncompress_batch([enc] * n, device=device, timing=spill_4x8)
            == [raw] * n, "leg 6 spill uncompress_batch bytes")
    raws_ = [leg3[w + "_spill"][0] for w in ("nx16_o1", "nx16_4way_o1")
             for _ in range(copies[w])]
    encs_ = [leg3[w + "_spill"][1] for w in ("nx16_o1", "nx16_4way_o1")
             for _ in range(copies[w])]
    require(uncompress_nx16_batch(encs_, device=device, timing=spill_nx16)
            == raws_, "leg 6 spill uncompress_nx16_batch bytes")
    notes = {"wall_s": time.time() - t0, "uncompress_batch_s": t1 - t0,
             "uncompress_nx16_batch_s": t2 - t1,
             "uncompress_batch": groups_4x8,
             "uncompress_nx16_batch": groups_nx16,
             "hifi_rows": {w: o1_rows_of(w, leg3[w + "_hifi"][1][0])
                           for w in O1_WIRES},
             "spill_s": time.time() - t2, "spill_copies": copies,
             "spill_uncompress_batch": spill_4x8,
             "spill_uncompress_nx16_batch": spill_nx16}
    for w, rows in notes["hifi_rows"].items():
        require(rows > 4096, f"leg 6 HiFi block on {w}: {rows} rows")
    return notes


class Shapes:
    """Inside a with block, the shapes of the launches of csrc/rans4x8.cu
    (B7, B8, X1-X3 and their dense variants: key, order-1 layout,
    streams, rounds of the longest stream), of X5 (key, payload bytes,
    max_records) and of X4 (key, members, the longest member's steps), in
    `got` (_build.SHAPES), so that launches no timing covers can be
    reckoned from their shapes."""

    def __enter__(self):
        from htslib_tpu_torch import _build
        self.got = _build.SHAPES = []
        return self

    def __exit__(self, *exc):
        from htslib_tpu_torch import _build
        _build.SHAPES = None


def _counted(run):
    """run() with the launch counts set to 0 just before it and read just
    after; the counts before it are added back.  Returns (its result, its
    launches by kernel)."""
    from htslib_tpu_torch import _build
    before = dict(_build.LAUNCHES)
    _build.reset_launches()
    out = run()
    mine = dict(_build.LAUNCHES)
    for k in _build.LAUNCHES:
        _build.LAUNCHES[k] = before.get(k, 0) + mine[k]
    return out, {k: v for k, v in mine.items() if v}


def leg8(device, chain, varied):
    """Leg 8, BAM -> SAM on the card: `chain`, leg 7's inflated record
    stream (X4's output), and `varied`, leg 8's varied stream, each
    through bam_payload_to_sam_device; every line must be the port's host
    formatter's (timed apart, in processes).  Returns its notes: each
    call's wall time, its parts from the entry point's `timing` dict, SAM
    MB/s, and both texts (chain_sam, varied_sam: legs 10b and 15 hold
    theirs to them)."""
    from htslib_tpu_torch.ops.bam2sam import bam_payload_to_sam_device
    from htslib_tpu_torch.sam.header import SamHeader
    hdr = SamHeader(ref_names=LEG8_REFS)
    notes = {}
    for name, payload in (("chain", chain), ("varied", varied)):
        timing = {}
        t0 = time.time()
        text = bam_payload_to_sam_device(payload, hdr, device=device,
                                         timing=timing)
        wall = time.time() - t0
        t1 = time.time()
        require(text == host_sam_parallel(payload, LEG8_REFS),
                f"leg 8 {name}: SAM text != host formatter")
        notes[name + "_sam"] = text
        notes[name] = {"wall_s": wall, "parts": timing,
                       "in_bytes": len(payload), "sam_bytes": len(text),
                       "sam_MBps": len(text) / wall / 1e6,
                       "check_s": time.time() - t1}
    return notes


class _Recording:
    """Within the block, module.name records each call's arguments and
    result into `calls`."""

    def __init__(self, module, name: str):
        self.module, self.name, self.calls = module, name, []

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def rec(*a, **k):
            out = self.orig(*a, **k)
            self.calls.append((a, k, out))
            return out
        setattr(self.module, self.name, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def _baq_pass(device, ref, recs, flag, timing=None):
    """sam_prob_realn_batch over copies of recs: (codes, the records'
    BAM bytes after, each HMM call's (args, kwargs, results))."""
    from htslib_tpu_torch import realn
    mine = [r.copy() for r in recs]
    with _Recording(realn, "probaln_arrays") as rec:
        codes = realn.sam_prob_realn_batch(mine, ref, flag, device=device,
                                           timing=timing)
    return codes, [r.to_bam_buffer() for r in mine], rec.calls


def baq_truth(device, ref, recs, flag):
    """_baq_pass with the HMM's plain version on the card (X6's place in
    ops/probaln.probaln_batch taken by probaln_plain)."""
    from htslib_tpu_torch.ops import probaln
    kernel = probaln.probaln_cuda
    probaln.probaln_cuda = probaln.probaln_plain
    try:
        return _baq_pass(device, ref, recs, flag)
    finally:
        probaln.probaln_cuda = kernel


def _same_hmm(calls, others) -> bool:
    """Whether two passes' HMM calls gave the same arrays."""
    return len(calls) == len(others) and all(
        np.array_equal(x, y) for (_, _, a), (_, _, b) in zip(calls, others)
        for x, y in zip(a, b))


def leg9(device, baq):
    """Leg 9, BAQ on the card: sam_prob_realn_batch with BAQ_APPLY over
    leg 9's reads, then over N_BAQ_FLAG reads of at most 1,000 bp for each
    other flag combination; the truth of each pass is the same pass with
    the HMM's plain version on the card, whose Pr, states and q, and every
    record after, must be equal.  Returns its notes: the APPLY pass's
    parts from the entry point's `timing` dict, each pass's codes, the
    truth's wall time; and the HMM calls' arguments for phase 6."""
    from htslib_tpu_torch.realn import BAQ_APPLY
    ref, recs = baq
    notes = {"reads": len(recs)}
    timing = {}
    t0 = time.time()
    codes, after, calls = _baq_pass(device, ref, recs, BAQ_APPLY, timing)
    notes["apply_wall_s"] = time.time() - t0
    notes["apply_parts"] = timing
    t0 = time.time()
    t_codes, t_after, t_calls = baq_truth(device, ref, recs, BAQ_APPLY)
    notes["truth_wall_s"] = time.time() - t0
    require(_same_hmm(calls, t_calls),
            "leg 9: X6's Pr, states or q != plain version")
    require(codes == t_codes and after == t_after,
            "leg 9: BAQ_APPLY records != plain version's")
    notes["apply_codes"] = {str(c): codes.count(c) for c in set(codes)}
    short = [r for r in recs if r.l_qseq <= 1000][:N_BAQ_FLAG]
    notes["flags"] = {}
    for flag in (0, 2, 3, 4, 5, 6, 7):
        got = _baq_pass(device, ref, short, flag)
        want = baq_truth(device, ref, short, flag)
        require(_same_hmm(got[2], want[2]) and got[:2] == want[:2],
                f"leg 9: flag {flag} != plain version's")
        notes["flags"][flag] = {str(c): got[0].count(c)
                                for c in set(got[0])}
    notes["hmm_calls"] = [(a, k) for a, k, _ in calls]
    return notes


def halo_layout(starts, ends, n: int = N_RANKS, tile: int = HALO_TILE):
    """Leg 10's halo-ring input: each read in a slot of the rank whose tile
    [d * tile, (d + 1) * tile) holds its start, every rank's slots padded
    with invalid reads to the fullest rank's count.  Returns global
    (starts, ends, valid), rank d's reads at rows [d * per, (d + 1) *
    per)."""
    owner = starts // tile
    per = int(np.bincount(owner, minlength=n).max())
    s = np.zeros(n * per, np.int32)
    e = np.zeros(n * per, np.int32)
    v = np.zeros(n * per, bool)
    for d in range(n):
        mine = np.flatnonzero(owner == d)
        at = d * per + np.arange(len(mine))
        s[at], e[at], v[at] = starts[mine], ends[mine], True
    return s, e, v


def leg10_steps(rank: int, n: int, batch, halo, device,
                tile: int = HALO_TILE):
    """The mesh steps at full size on one rank of a world of n: the
    decode-pileup step over its share of leg 1's batch (tile 1 << 20),
    the flagstat step over the same records' flags, and the halo ring
    over n tiles of `tile` (halo 1,024).  Each step runs twice, the
    second run timed; returns the outputs (coverage whole, bases and
    flags this rank's rows, counts, this rank's halo tile) and times."""
    from htslib_tpu_torch._build import clock
    from htslib_tpu_torch.parallel.mesh import (make_coord_sharded_pileup,
                                                make_decode_pileup_step,
                                                make_flagstat_step,
                                                make_mesh, shard_batch)
    cores, seq4, starts, ends, valid = batch
    flags = (cores[:, 14].astype(np.int32)
             | (cores[:, 15].astype(np.int32) << 8))
    mesh = make_mesh(n=n, device=device)
    t0 = clock(device)
    shards = shard_batch(mesh, cores, seq4, starts, ends, valid)
    fshards = shard_batch(mesh, flags, valid)
    hshards = shard_batch(mesh, *halo)
    out = {"shard_s": clock(device) - t0}
    steps = (("decode_pileup", make_decode_pileup_step(mesh, TILE_LEN),
              shards + (0,)),
             ("flagstat", make_flagstat_step(mesh), fshards),
             ("halo", make_coord_sharded_pileup(mesh, tile, HALO),
              hshards))
    for name, step, args in steps:
        step(*args)
        before = dict(mesh.timing)
        t0 = clock(device)
        res = step(*args)
        out[name + "_s"] = clock(device) - t0
        out[name + "_collective"] = {k: mesh.timing[k] - before[k]
                                     for k in mesh.timing}
        out[name] = (tuple(r.cpu().numpy() for r in res)
                     if isinstance(res, tuple) else res.cpu().numpy())
    out["backend"] = mesh.backend
    return out


def leg10a(batch):
    """Leg 10a: a world of one under NCCL on the card (initialize with
    tcp on localhost), dryrun_multichip(1), then the full-size steps;
    the process group is torn down before leg 10b."""
    import socket

    import torch.distributed as dist

    from htslib_tpu_torch.entry import dryrun_multichip
    from htslib_tpu_torch.parallel.distributed import initialize
    cores, _seq4, starts, ends, _valid = batch
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.time()
    initialize(f"127.0.0.1:{port}", 1, 0, backend="nccl")
    try:
        notes = {"init_s": time.time() - t0}
        t0 = time.time()
        dryrun_multichip(1, device="cuda")
        notes["dryrun_s"] = time.time() - t0
        out = leg10_steps(0, 1, batch, halo_layout(starts, ends, 1, 1 << 20),
                          "cuda", tile=1 << 20)
    finally:
        dist.destroy_process_group()
    require(out["backend"] == "nccl", f"leg 10a backend {out['backend']}")
    check_leg10(batch, [out], 1, 1 << 20)
    notes.update({k: v for k, v in out.items()
                  if k.endswith("_s") or k.endswith("_collective")})
    return notes


def check_leg10(batch, outs, n: int, tile: int):
    """The full-size steps' outputs of n ranks against numpy: coverage on
    every rank, the gathered bases and flags, the counts on every rank,
    the gathered halo tiles."""
    cores, seq4, starts, ends, _valid = batch
    flags = cores[:, 14].astype(np.int64) | (cores[:, 15].astype(np.int64)
                                             << 8)
    cov_np = coverage_numpy(starts, ends, TILE_LEN)
    for r, out in enumerate(outs):
        require(np.array_equal(out["decode_pileup"][0], cov_np),
                f"leg 10 rank {r}: mesh coverage")
        require(np.array_equal(out["flagstat"], flag_counts_numpy(flags)),
                f"leg 10 rank {r}: mesh flagstat")
    require(np.array_equal(np.concatenate(
        [o["decode_pileup"][1] for o in outs]), nt16_numpy(seq4)),
        "leg 10 gathered bases")
    require(np.array_equal(np.concatenate(
        [o["decode_pileup"][2] for o in outs]), flags), "leg 10 flags")
    require(np.array_equal(np.concatenate([o["halo"] for o in outs]),
                           coverage_numpy(starts, ends, n * tile)),
            "leg 10 halo ring")


def flag_counts_numpy(f):
    """The 11 flagstat counters of flags f (all records valid)."""
    pm = ((f & 1) != 0) & ((f & 4) == 0)
    return np.array([len(f), ((f & 0x100) != 0).sum(),
                     ((f & 0x800) != 0).sum(), ((f & 0x400) != 0).sum(),
                     ((f & 4) == 0).sum(), ((f & 1) != 0).sum(),
                     ((f & 0x40) != 0).sum(), ((f & 0x80) != 0).sum(),
                     ((f & 2) != 0).sum(), (pm & ((f & 8) == 0)).sum(),
                     (pm & ((f & 8) != 0)).sum()], np.int64)


def leg10_rank(rank: int, n: int, device, batch, halo, plan, refs,
               cram_plan, bcf_plan):
    """One of leg 10b's gloo ranks, its work on `device` (cuda:0): the
    dryrun, the full-size steps, then its shard of the BAM file (decode,
    X4, X5 and B1; flagstat), its shard of leg 11a's CRAM file (rANS
    blocks on the card, records on the host, X5 and B1) and its shard of
    leg 12's BCF file (its members through X4, records on the host).
    Returns its outputs, times and kernel launches (the CRAM and BCF
    shards' apart)."""
    import torch

    from htslib_tpu_torch import _build
    from htslib_tpu_torch.entry import dryrun_multichip
    from htslib_tpu_torch.parallel.distributed import (
        decode_bcf_shard_to_vcf, decode_cram_shard_to_sam,
        decode_shard_to_sam, flagstat_shard)
    from htslib_tpu_torch.sam.header import SamHeader
    _build.reset_launches()
    shapes = Shapes().__enter__()
    t0 = _build.clock(device)
    torch.zeros(1, device=device)
    out = {"device_init_s": _build.clock(device) - t0, "shapes": shapes.got}
    t0 = _build.clock(device)
    dryrun_multichip(n, device=device)
    out["dryrun_s"] = _build.clock(device) - t0
    out.update(leg10_steps(rank, n, batch, halo, device))
    shard = plan.shards[rank]
    t0 = _build.clock(device)
    out["sam"] = decode_shard_to_sam(plan, shard, SamHeader(ref_names=refs),
                                     device=device)
    out["decode_s"] = _build.clock(device) - t0
    t0 = _build.clock(device)
    out["shard_counts"] = flagstat_shard(plan, shard, device=device)
    out["shard_flagstat_s"] = _build.clock(device) - t0
    before = dict(_build.LAUNCHES)
    timing = {}
    t0 = _build.clock(device)
    out["cram_sam"] = decode_cram_shard_to_sam(
        cram_plan, cram_plan.shards[rank], device=device, timing=timing)
    out["cram_decode_s"] = _build.clock(device) - t0
    out["cram_parts_s"] = {k: v for k, v in timing.items()
                           if k.endswith("_s")}
    out["cram_launches"] = {k: v - before[k] for k, v in
                            _build.LAUNCHES.items() if v > before[k]}
    before = dict(_build.LAUNCHES)
    timing = {}
    t0 = _build.clock(device)
    out["vcf"] = decode_bcf_shard_to_vcf(bcf_plan, bcf_plan.shards[rank],
                                         device=device, timing=timing)
    out["bcf_decode_s"] = _build.clock(device) - t0
    out["bcf_parts_s"] = timing
    out["bcf_launches"] = {k: v - before[k] for k, v in
                           _build.LAUNCHES.items() if v > before[k]}
    out["launches"] = {k: v for k, v in _build.LAUNCHES.items() if v}
    return out


def write_leg10_bam(path: str, bgzf) -> None:
    """Leg 10's BAM file: a header member (LEG8_REFS, 300 Mbp each), leg
    7's members, the EOF member."""
    from htslib_tpu_torch.bgzf import BGZF_EOF, bgzf_member, compress_block
    from htslib_tpu_torch.sam.bam import write_bam_header
    from htslib_tpu_torch.sam.header import SamHeader
    head = io.BytesIO()
    write_bam_header(head, SamHeader("".join(
        f"@SQ\tSN:{r}\tLN:300000000\n" for r in LEG8_REFS)))
    with open(path, "wb") as fp:
        fp.write(compress_block(head.getvalue()))
        for deflated, piece in zip(*bgzf):
            fp.write(bgzf_member(deflated, piece))
        fp.write(BGZF_EOF)


def leg10b(device, batch, bgzf, chain_sam, cram_plan, bcf_plan, path):
    """Leg 10b: N_RANKS gloo ranks (spawned processes, compute on device)
    run dryrun_multichip(N_RANKS), the full-size steps and a shard each of
    leg 7's stream written as a BAM file (a header member, leg 7's 1,232
    members, the EOF member), planned once here, a shard each of leg
    11a's CRAM file (`cram_plan`) and a shard each of leg 12's BCF file
    (`bcf_plan`).  Every output is held against numpy, the shards' SAM
    text against leg 8's single-process text, their counters against the
    flagstat step's (the CRAM and BCF shards are held by leg11_check and
    leg12_check).  The BAM is written to `path`, which leg 14 reads
    after.  Returns its notes with each rank's launches, the CRAM and BCF
    shards' apart, and the ranks' outputs."""
    import torch

    from htslib_tpu_torch.parallel.distributed import plan_bam_shards
    from htslib_tpu_torch.parallel.launch import run_ranks
    _cores, _seq4, starts, ends, _valid = batch
    t0 = time.time()
    write_leg10_bam(path, bgzf)
    plan = plan_bam_shards(path, N_RANKS)
    require(len(plan.shards) == N_RANKS, "leg 10 plan's shards")
    notes = {"bam_bytes": os.path.getsize(path),
             "members": len(plan.coffsets), "setup_s": time.time() - t0}
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    ranks = {}
    outs = run_ranks(leg10_rank, N_RANKS, (
        device, batch, halo_layout(starts, ends), plan, LEG8_REFS,
        cram_plan, bcf_plan),
        backend="gloo", timeout=LEG10_TIMEOUT, timing=ranks)
    notes["ranks_s"] = ranks.pop("wall_s")
    t0 = time.time()
    check_leg10(batch, outs, N_RANKS, HALO_TILE)
    require(all(o["backend"] == "gloo" for o in outs), "leg 10b backend")
    sam = b"".join(o.pop("sam") for o in outs)
    require(sam == chain_sam, "leg 10 sharded decode != single-host SAM")
    counts = sum(o["shard_counts"] for o in outs)
    require(np.array_equal(counts, outs[0]["flagstat"]),
            "leg 10 shard flagstat != mesh flagstat step")
    notes["check_s"] = time.time() - t0
    decode = max(o["decode_s"] for o in outs)
    notes["sam_bytes"] = len(sam)
    notes["sharded_decode_s"] = decode
    notes["sharded_decode_MBps"] = len(sam) / decode / 1e6
    notes["rank_launches"] = {}
    notes["rank_cram_launches"] = {}
    notes["rank_bcf_launches"] = {}
    for o in outs:
        for key, sub in (("rank_launches", "launches"),
                         ("rank_cram_launches", "cram_launches"),
                         ("rank_bcf_launches", "bcf_launches")):
            for k, v in o[sub].items():
                notes[key][k] = notes[key].get(k, 0) + v
    notes["ranks"] = [{k: v for k, v in o.items() if k.endswith("_s")
                       or k.endswith("_collective") or k == "launches"}
                      for o in outs]
    notes["rank_shapes"] = [o.pop("shapes") for o in outs]
    notes["outs"] = outs
    for r, rank in enumerate(notes["ranks"]):
        rank.update({k: v[r] for k, v in ranks.items()})
    return notes


def leg11_records(n: int, seed: int, seqs):
    """Leg 11's records: varied_bam_stream(n, seed) with reads starting
    within CRAM_SPAN of their reference, sorted by reference and position
    (unmapped last), their M/=/X bases copied from `seqs` (name -> uint8
    bases) with 2% substituted.  Returns the u32-framed payload."""
    from htslib_tpu_torch.sam.record import BamRecord
    rng = np.random.default_rng(seed)
    payload = varied_bam_stream(n, seed, pos_span=CRAM_SPAN)
    mv, recs, p = memoryview(payload), [], 0
    while p < len(payload):
        size = int.from_bytes(payload[p:p + 4], "little")
        recs.append(BamRecord.from_bam_buffer(mv, p + 4, size))
        p += 4 + size
    recs.sort(key=lambda r: (r.tid < 0, r.tid, r.pos))
    acgt = np.frombuffer(b"ACGT", np.uint8)
    out = []
    for b in recs:
        if b.tid >= 0 and b.l_qseq:
            ref = seqs[LEG8_REFS[b.tid]]
            seq = np.frombuffer(b.seq.encode(), np.uint8).copy()
            q, rp = 0, b.pos
            for c in b.cigar.tolist():
                op, ln = c & 15, c >> 4
                if op in (0, 7, 8):
                    seq[q:q + ln] = np.where(rng.random(ln) < 0.02,
                                             acgt[rng.integers(0, 4, ln)],
                                             ref[rp:rp + ln])
                q += ln if op in (0, 1, 4, 7, 8) else 0
                rp += ln if op in (0, 2, 3, 7, 8) else 0
            b.set_seq(seq.tobytes().decode(), b.qual)
        body = b.to_bam_buffer()
        out.append(struct.pack("<I", len(body)) + body)
    return b"".join(out)


def leg11_inputs(tmp: str, seed: int = 11):
    """Leg 11's files in `tmp`: a seeded FASTA of LEG8_REFS, each
    CRAM_SPAN + 1,000 bases (longer than any read's end), with its .fai
    built here once; leg11_records over it written as a BAM for 11a
    (N_CRAM records) and 11b (N_CRAM31).  Returns (fasta, bam_a, bam_b)."""
    from htslib_tpu_torch.faidx import Faidx
    from htslib_tpu_torch.sam.bam import write_bam_header
    from htslib_tpu_torch.sam.header import SamHeader
    from htslib_tpu_torch.bgzf import BgzfWriter
    rng = np.random.default_rng(seed)
    length = CRAM_SPAN + 1000
    fasta = os.path.join(tmp, "leg11.fa")
    seqs = {}
    with open(fasta, "wb") as fp:
        for name in LEG8_REFS:
            seqs[name] = np.frombuffer(b"ACGT", np.uint8)[
                rng.integers(0, 4, length)]
            lines = seqs[name].tobytes()
            fp.write(b">" + name.encode() + b"\n" + b"".join(
                lines[i:i + 60] + b"\n" for i in range(0, length, 60)))
    Faidx.load(fasta)
    hdr = SamHeader("@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{name}\tLN:{length}\n" for name in LEG8_REFS))
    bams = []
    for tag, n in (("a", N_CRAM), ("b", N_CRAM31)):
        path = os.path.join(tmp, f"leg11{tag}.bam")
        with BgzfWriter(path, level=1) as w:
            write_bam_header(w, hdr)
            w.write(leg11_records(n, seed + len(bams) + 1, seqs))
        bams.append(path)
    return fasta, bams[0], bams[1]


def cram_blocks(path: str):
    """(container offset, the container's CORE and EXTERNAL blocks) of
    every data container of a CRAM file, read on the host."""
    from htslib_tpu_torch.cram import CRAM_EOF_START
    from htslib_tpu_torch.cram.io import CramIO, read_file_definition
    from htslib_tpu_torch.cram.structs import CT_CORE, CT_EXTERNAL
    out = []
    with open(path, "rb") as fp:
        version, _ = read_file_definition(fp)
        io_ = CramIO(fp, version)
        c = io_.read_container_header()
        fp.seek(c.data_offset + c.length)
        while True:
            c = io_.read_container_header()
            if c is None or (c.ref_seq_id == -1
                             and c.ref_seq_start == CRAM_EOF_START):
                break
            end = c.data_offset + c.length
            blocks = []
            while fp.tell() < end:
                b = io_.read_block()
                if b.content_type in (CT_CORE, CT_EXTERNAL):
                    blocks.append(b)
            if c.num_records:
                out.append((c.offset, blocks))
    return out


def _host_cram_truth(path: str, ref, offset: int, blob: bool = False):
    """The host chain over the container at `offset`: each data block
    decoded by the port's host codec (its MD5, in file order), each slice
    decoded by cram/decode.py and every record formatted by sam/record.py
    to_sam.  Returns (digests, SAM text), and with `blob` the slices'
    u32-framed record blobs too (decode_slice_blob over the same host-
    decoded blocks, leg 17d's truth)."""
    import hashlib
    from htslib_tpu_torch.cram import CramReader
    from htslib_tpu_torch.cram.batch import _slice_jobs
    from htslib_tpu_torch.cram.decode import decode_slice, decode_slice_blob
    from htslib_tpu_torch.cram.structs import CT_CORE, CT_EXTERNAL
    digests, lines, blobs = [], [], []
    with CramReader(path, ref=ref) as r:
        r.fp.seek(offset)
        for chdr, sh, blocks in _slice_jobs(r, offset + 1):
            digests += [hashlib.md5(b.uncompress()).digest() for b in blocks
                        if b.content_type in (CT_CORE, CT_EXTERNAL)]
            lines += [rec.to_sam(r.header) for rec in decode_slice(
                chdr, sh, blocks, r.header, r.refs.get, r.version[0])]
            if blob:
                blobs.append(decode_slice_blob(chdr, sh, blocks, r.header,
                                               r.refs.get, r.version[0]))
    text = ("\n".join(lines) + "\n").encode() if lines else b""
    return (digests, text, b"".join(blobs)) if blob else (digests, text)


def leg11(device, tmp: str):
    """Leg 11's work in this process: 11a's BAM written as a reference-
    based CRAM 3.0 (CRAM_SLICE records a slice) and decoded whole by
    cram_file_to_sam on the card, then planned into N_RANKS shards for
    leg 10b's ranks; 11b's BAM written as a CRAM 3.1 without a reference
    and decoded whole.  Returns its notes (times, the texts, the plan,
    blocks by wire from a host pass over each file)."""
    from htslib_tpu_torch.cram.batch import (bam_to_cram_file, block_wire,
                                             cram_file_to_sam)
    from htslib_tpu_torch.parallel.distributed import plan_cram_shards
    t0 = time.time()
    fasta, bam_a, bam_b = leg11_inputs(tmp)
    notes = {"inputs_s": time.time() - t0}
    for tag, bam, ref, version in (("11a", bam_a, fasta, (3, 0)),
                                   ("11b", bam_b, None, (3, 1))):
        cram = os.path.join(tmp, f"leg{tag}.cram")
        t0 = time.time()
        n = bam_to_cram_file(bam, cram, ref=ref, version=version,
                             seqs_per_slice=CRAM_SLICE,
                             write_index=tag == "11a")
        leg = {"records": n, "encode_s": time.time() - t0,
               "cram_bytes": os.path.getsize(cram), "path": cram,
               "ref": ref, "bam": bam}
        leg["wires"] = {}
        for _, blocks in cram_blocks(cram):
            for b in blocks:
                w = block_wire(b) or "host"
                leg["wires"][w] = leg["wires"].get(w, 0) + 1
        timing = {}
        t0 = time.time()
        _, sam = cram_file_to_sam(cram, ref=ref, device=device,
                                  timing=timing)
        leg["decode_s"] = time.time() - t0
        leg["sam"] = sam.tobytes()
        leg["sam_MBps"] = len(sam) / leg["decode_s"] / 1e6
        leg["parts"] = {k: v for k, v in timing.items()
                        if k not in ("wires", "format")}
        leg["format_parts"] = timing["format"]
        require(timing["records"] == n, f"leg {tag} records")
        notes[tag] = leg
    plan = plan_cram_shards(notes["11a"]["path"], N_RANKS, ref=fasta)
    require(len(plan.shards) == N_RANKS, "leg 11a plan's shards")
    notes["plan"] = plan
    return notes


def leg11_check(device, notes, rank_outs, pool):
    """Leg 11's truths, after leg 10b's ranks decoded 11a's shards: every
    data block of both files decoded by decode_blocks on the card (its
    launches not counted) equals the host codec's bytes; each whole-file
    text equals the host chain's (_host_cram_truth, a task of `pool` a
    container); the ranks' shards in order equal 11a's whole text.
    Returns the notes of the check."""
    import hashlib

    from htslib_tpu_torch import _build
    from htslib_tpu_torch.cram.batch import decode_blocks
    t0 = time.time()
    jobs = [(tag, notes[tag]["path"], notes[tag]["ref"], off, blocks)
            for tag in ("11a", "11b")
            for off, blocks in cram_blocks(notes[tag]["path"])]
    futs = [pool.submit(_host_cram_truth, path, ref, off, tag == "11a")
            for tag, path, ref, off, _ in jobs]
    before = dict(_build.LAUNCHES)
    n_dev = 0
    for *_, blocks in jobs:
        counts = decode_blocks(blocks, device=device)
        n_dev += sum(v for k, v in counts.items() if k != "host")
    _build.LAUNCHES.update(before)
    truths = [f.result() for f in futs]
    for (tag, _, _, off, blocks), (digests, *_) in zip(jobs, truths):
        got = [hashlib.md5(b._uncompressed).digest() for b in blocks]
        require(got == digests, f"leg {tag} container at {off}: a block "
                "decoded on the card != the host codec's bytes")
    for tag in ("11a", "11b"):
        text = b"".join(t for (g, *_), (_, t, *_) in zip(jobs, truths)
                        if g == tag)
        require(notes[tag]["sam"] == text,
                f"leg {tag} SAM != the host chain's")
    shards = b"".join(o.pop("cram_sam") for o in rank_outs)
    require(shards == notes["11a"]["sam"],
            "leg 11a sharded CRAM decode != single-process SAM")
    return {"check_s": time.time() - t0, "blocks_checked":
            sum(len(j[4]) for j in jobs), "device_blocks_checked": n_dev,
            "shards_sam_MBps": len(shards) / max(
                o["cram_decode_s"] for o in rank_outs) / 1e6,
            "texts_11a": {off: t for (g, _, _, off, _), (_, t, *_)
                          in zip(jobs, truths) if g == "11a"},
            "blob_11a": b"".join(b for (g, *_), (*_, b) in zip(jobs, truths)
                                 if g == "11a")}


def leg13_regions(index, lens, seed: int = 13):
    """Leg 13a's N_REGIONS regions (tid, beg, end; 0-based, end
    exclusive) on 11a's references: two across the boundary of two
    slices of one reference (from its .crai entries), one past a
    reference's end, the rest seeded, 1 kb to 500 kb long."""
    rng = np.random.default_rng(seed)
    out = []
    by_ref = {}
    for e in index.entries:
        if e.refid >= 0:
            by_ref.setdefault(e.refid, []).append(e)
    for es in by_ref.values():
        for a, b in zip(es, es[1:]):
            if len(out) < 2 and a.offset != b.offset:
                cut = b.start - 1          # 0-based start of slice b
                out.append((a.refid, cut - 700, cut + 700))
    require(len(out) == 2, f"leg 13a: slice boundaries {out}")
    out.append((0, lens[0] + 1000, lens[0] + 2000))
    while len(out) < N_REGIONS:
        tid = int(rng.integers(0, 2))
        span = int(np.exp(rng.uniform(np.log(1000), np.log(500_000))))
        beg = int(rng.integers(0, CRAM_SPAN - span))
        out.append((tid, beg, beg + span))
    return out


def region_runs(offsets, every):
    """Runs of consecutive containers among `offsets` (container offsets
    of a region, in file order): (first offset, the offset of the
    container after the run, or None past the last)."""
    nxt = dict(zip(every, every[1:] + [None]))
    runs = []
    for off in offsets:
        if runs and runs[-1][1] == off:
            runs[-1][1] = nxt[off]
        else:
            runs.append([off, nxt[off]])
    return [tuple(r) for r in runs]


def sam_overlaps(line: str, name: str, beg: int, end: int) -> bool:
    """Whether a SAM line lies on `name` and overlaps [beg, end) (0-based),
    its end as bam_endpos reckons it (at least one base)."""
    import re
    f = line.split("\t")
    pos = int(f[3]) - 1
    rlen = 0 if int(f[1]) & 4 else sum(
        int(n) for n, op in re.findall(r"(\d+)([MIDNSHP=X])", f[5])
        if op in "MDN=X")
    return f[2] == name and pos < end and pos + (rlen or 1) > beg


def cram_header(path: str):
    """The SAM header of a CRAM, read by the port's CramReader."""
    from htslib_tpu_torch.cram import CramReader
    with CramReader(path) as r:
        return r.header


def _leg13_encode(bam: str, cram: str, fasta: str, per_slice: int):
    """Leg 13d's file: `bam` written against `fasta` as CRAM 3.1 with
    device_profile, `per_slice` records a slice.  Returns (records, s)."""
    from htslib_tpu_torch.cram.batch import bam_to_cram_file
    t0 = time.time()
    n = bam_to_cram_file(bam, cram, ref=fasta, version=(3, 1),
                         seqs_per_slice=per_slice, device_profile=True)
    return n, time.time() - t0


def _leg13_fetch(path: str, fasta: str, region, exprs):
    """Host truths of a 13a region: CramReader.fetch's records formatted
    by to_sam; for each of `exprs`, each record's sam_passes_filter
    verdict and the records fetch yields with the reader's filter set."""
    from htslib_tpu_torch.cram import CramReader
    from htslib_tpu_torch.hts_expr import HtsFilter, sam_passes_filter
    with CramReader(path, ref=fasta) as r:
        recs = list(r.fetch(*region))
        lines = [rec.to_sam(r.header) for rec in recs]
        verdicts, with_filter = {}, {}
        for expr in exprs:
            f = HtsFilter(expr)
            verdicts[expr] = [sam_passes_filter(rec, r.header, f)
                              for rec in recs]
            r.set_filter(expr)
            with_filter[expr] = [rec.to_sam(r.header)
                                 for rec in r.fetch(*region)]
            r.set_filter(None)
    return lines, verdicts, with_filter


def _leg13_fields(path: str, fasta: str, offset: int, mask: int):
    """13b on the host: the container at `offset` decoded with
    required_fields `mask`.  Returns (decode s, blocks left compressed,
    blocks, MD5s of the QUAL, FLAG/POS/MAPQ and SEQ/CIGAR fields of its
    records)."""
    import hashlib
    from htslib_tpu_torch.cram import CramReader
    from htslib_tpu_torch.cram.batch import _slice_jobs
    from htslib_tpu_torch.cram.decode import decode_slice
    digests = [hashlib.md5() for _ in range(3)]
    secs, left, n_blocks = 0.0, 0, 0
    with CramReader(path, ref=fasta) as r:
        r.fp.seek(offset)
        for chdr, sh, blocks in _slice_jobs(r, offset + 1):
            t0 = time.time()
            recs = decode_slice(chdr, sh, blocks, r.header, r.refs.get,
                                r.version[0], required_fields=mask)
            secs += time.time() - t0
            left += sum(b._uncompressed is None for b in blocks)
            n_blocks += len(blocks)
            for rec in recs:
                digests[0].update(rec.qual)
                digests[1].update(struct.pack("<Hii", rec.flag, rec.pos,
                                              rec.mapq))
                digests[2].update(struct.pack("<i", rec.l_qseq) + rec.seq4
                                  + rec.cigar.tobytes())
    return secs, left, n_blocks, [d.hexdigest() for d in digests]


def _leg13_qs_hist(path: str):
    """The histogram ([QBINS]) of every QS block of a CRAM, each decoded
    by the port's host codec."""
    from htslib_tpu_torch.ops.device_stats import QBINS, QS_CONTENT_ID
    hist = np.zeros(QBINS, np.int64)
    for _, blocks in cram_blocks(path):
        for b in blocks:
            if b.content_id == QS_CONTENT_ID:
                hist += hist_of(b.uncompress(), QBINS)
    return hist


def _leg13_build_crai(path: str, fasta: str, out: str):
    from htslib_tpu_torch.cram.index import build_crai
    return [tuple(vars(e).values())
            for e in build_crai(path, out, ref=fasta).entries]


def leg13(device, tmp: str, l11):
    """Leg 13's work on the card, after leg 11: 11a's regions through its
    .crai (13a), 11a's file decoded by M5 from REF_CACHE and REF_PATH
    with its FASTA moved away (13c), and 11b's BAM as a reference-based
    CRAM 3.1 with device_profile, written in a process of its own while
    13a and 13c run, then decoded and histogrammed on the card (13d).
    Returns its notes; the host truths are leg13_check's."""
    from htslib_tpu_torch.cram.batch import (block_wire, cram_file_to_sam,
                                             cram_range_to_sam)
    from htslib_tpu_torch.cram.index import CramIndex
    from htslib_tpu_torch.ops.device_stats import (QS_CONTENT_ID,
                                                   cram_qual_hist)
    a = l11["11a"]
    path, fasta = a["path"], a["ref"]
    notes = {}
    # 13d's encode reads a copy of the FASTA, which 13c moves meanwhile
    fasta_d = os.path.join(tmp, "leg13d.fa")
    with open(fasta, "rb") as src, open(fasta_d, "wb") as dst:
        dst.write(src.read())
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=1, mp_context=ctx) as enc_pool:
        cram31 = os.path.join(tmp, "leg13d.cram")
        enc = enc_pool.submit(_leg13_encode, l11["11b"]["bam"], cram31,
                              fasta_d, LEG13D_SLICE)
        # 13a: each region's containers from the index, decoded in runs
        idx = CramIndex.load(path + ".crai")
        every = sorted({e.offset for e in idx.entries})
        hdr = cram_header(path)
        regions = leg13_regions(idx, [hdr.tid2len(t)
                                      for t in range(hdr.nref)])
        out, n_cont, t0 = [], 0, time.time()
        for tid, beg, end in regions:
            offsets = idx.container_offsets(tid, beg + 1, end)
            texts = []
            for off, stop in region_runs(offsets, every):
                _, sam = cram_range_to_sam(path, off, stop, ref=fasta,
                                           device=device)
                texts.append((off, stop, sam.tobytes()))
            n_cont += len(offsets)
            out.append({"region": (tid, beg, end), "runs": texts,
                        "containers": len(offsets)})
        secs = time.time() - t0
        require(out[2]["runs"] == [], "leg 13a: a region past the "
                "reference's end hit containers")
        notes["13a"] = {"regions": out, "containers": n_cont,
                        "decode_s": secs, "ms_a_region":
                        secs / len(regions) * 1e3}
        # 13c: REF_CACHE, then REF_PATH, with the FASTA moved away
        notes["13c"] = leg13c(device, tmp, path, fasta, a["sam"])
        # 13d
        n31, encode_s = enc.result()
    d = {"records": n31, "encode_s": encode_s,
         "cram_bytes": os.path.getsize(cram31), "path": cram31,
         "ref": fasta_d}
    qs, wires = [], {}
    for _, blocks in cram_blocks(cram31):
        for b in blocks:
            w = block_wire(b) or "host"
            wires[w] = wires.get(w, 0) + 1
            if b.content_id == QS_CONTENT_ID:
                qs.append((w, b.raw_size))
    require(all(w.startswith("nx16_32way") for w, n in qs if n >= 64),
            f"leg 13d: QS blocks not on a 32-way wire {qs}")
    d["wires"], d["qs_wires"] = wires, [w for w, _ in qs]
    timing = {}
    t0 = time.time()
    _, sam = cram_file_to_sam(cram31, ref=fasta_d, device=device,
                              timing=timing)
    d["decode_s"] = time.time() - t0
    d["sam"] = sam.tobytes()
    d["sam_MBps"] = len(sam) / d["decode_s"] / 1e6
    d["parts"] = {k: v for k, v in timing.items() if k != "format"}
    require(timing["records"] == n31, "leg 13d records")
    stats = {}
    t0 = time.time()
    d["hist"] = cram_qual_hist(cram31, device=device, stats=stats)
    d["hist_s"] = time.time() - t0
    d["hist_blocks"] = stats
    require(stats["device_blocks"] == len(qs) and stats["host_blocks"] == 0,
            f"leg 13d: quality blocks not all on the card {stats}")
    notes["13d"] = d
    return notes


def leg13c(device, tmp: str, path: str, fasta: str, want: bytes):
    """11a's file decoded on the card with no ref= after its FASTA (the
    @SQ lines' UR) is moved away: its sequences found by M5 in a
    REF_CACHE directory built here, then in a REF_PATH template.  Both
    texts must equal 11a's.  The FASTA is moved back after."""
    import hashlib
    from htslib_tpu_torch.cram.batch import cram_file_to_sam
    from htslib_tpu_torch.faidx import Faidx
    cache = os.path.join(tmp, "ref_cache")
    os.makedirs(cache, exist_ok=True)
    fai = Faidx.load(fasta)
    for ln in cram_header(path).lines:
        if ln.type == "SQ":
            seq = fai.fetch_seq(ln.get("SN")).encode().upper()
            require(hashlib.md5(seq).hexdigest() == ln.get("M5"),
                    "leg 13c: an @SQ line's M5")
            with open(os.path.join(cache, ln.get("M5")), "wb") as fp:
                fp.write(seq)
    fai.close()
    moved = fasta + ".moved"
    notes = {}
    saved = {k: os.environ.get(k) for k in ("REF_CACHE", "REF_PATH")}
    os.rename(fasta, moved)
    try:
        for key, val in (("REF_CACHE", cache),
                         ("REF_PATH", os.path.join(tmp, "no_such_dir") + ":"
                          + os.path.join(cache, "%s"))):
            for k in saved:
                os.environ.pop(k, None)
            os.environ[key] = val
            t0 = time.time()
            _, sam = cram_file_to_sam(path, device=device)
            notes[key + "_s"] = time.time() - t0
            require(sam.tobytes() == want,
                    f"leg 13c: SAM by {key} != leg 11a's")
    finally:
        os.rename(moved, fasta)
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    return notes


def leg13_check(notes, l11, truths_11a, pool):
    """Leg 13's host truths in `pool`, after leg 11's: build_crai equals
    the encoder's .crai (13a.1); each region's card text equals the host
    chain's over its containers (leg 11's truths, 13a.3) and its lines
    that overlap the region equal fetch's records (13a.4); the region
    lines of records passing each filter expression equal the host
    records passing sam_passes_filter (13e); each required-fields mask's
    fields equal the full decode's (13b); 13d's text and histogram equal
    the host chain's.  Returns its notes."""
    from htslib_tpu_torch.cram.index import CramIndex
    from htslib_tpu_torch.cram.decode import (SAM_CIGAR, SAM_FLAG, SAM_MAPQ,
                                              SAM_POS, SAM_QUAL, SAM_SEQ)
    t0 = time.time()
    a = l11["11a"]
    path, fasta = a["path"], a["ref"]
    regions = notes["13a"]["regions"]
    # 13e's regions: the two longest that hit containers
    filtered = sorted((i for i, r in enumerate(regions) if r["runs"]),
                      key=lambda i: regions[i]["region"][1]
                      - regions[i]["region"][2])[:2]
    crai = pool.submit(_leg13_build_crai, path, fasta,
                       path + ".rebuilt.crai")
    fetches = [pool.submit(_leg13_fetch, path, fasta, r["region"],
                           LEG13_FILTERS if i in filtered else [])
               for i, r in enumerate(regions)]
    # 13b: each mask, and the digests of _leg13_fields it must match
    masks = [("SAM_QUAL", SAM_QUAL, [0]),
             ("SAM_FLAG|SAM_POS|SAM_MAPQ", SAM_FLAG | SAM_POS | SAM_MAPQ,
              [1]),
             ("SAM_SEQ|SAM_CIGAR", SAM_SEQ | SAM_CIGAR, [2]),
             ("0 (everything)", 0, [0, 1, 2])]
    offsets = sorted(truths_11a)
    fields = [[pool.submit(_leg13_fields, path, fasta, off, m)
               for off in offsets] for _, m, _ in masks]
    d = notes["13d"]
    d_truth = [pool.submit(_host_cram_truth, d["path"], d["ref"], off)
               for off, _ in cram_blocks(d["path"])]
    d_hist = pool.submit(_leg13_qs_hist, d["path"])
    out = {}
    written = [tuple(vars(e).values())
               for e in CramIndex.load(path + ".crai").entries]
    require(crai.result() == written, "leg 13a: build_crai != the "
            "encoder's .crai")
    out["crai_entries"] = len(written)
    hdr = cram_header(path)
    names = [hdr.tid2name(t) for t in range(hdr.nref)]
    hits, passed = 0, []
    for r, fut in zip(regions, fetches):
        tid, beg, end = r["region"]
        lines, verdicts, with_filter = fut.result()
        card = []
        for off, stop, text in r["runs"]:
            want = b"".join(truths_11a[o] for o in offsets
                            if o >= off and (stop is None or o < stop))
            require(text == want, f"leg 13a: region {r['region']}'s run at "
                    f"{off} != the host chain's text")
            card += [ln for ln in text.decode().splitlines()
                     if sam_overlaps(ln, names[tid], beg, end)]
        require(card == lines, f"leg 13a: region {r['region']}'s lines != "
                "CramReader.fetch's records")
        hits += len(lines)
        for expr, v in verdicts.items():
            got = [ln for ln, ok in zip(card, v) if ok]
            require(got == [ln for ln, ok in zip(lines, v) if ok],
                    f"leg 13e: {expr!r} over {r['region']}")
            # the JAX fetch (and so the port's) ignores the reader's filter
            require(with_filter[expr] == lines,
                    f"leg 13e: fetch with {expr!r} set")
            passed.append((r["region"], expr, len(got), len(lines)))
    out["region_records"] = hits
    require(len(passed) == 2 * len(LEG13_FILTERS)
            and 0 < sum(p[2] for p in passed) < sum(p[3] for p in passed),
            f"leg 13e: the filters passed {passed}")
    out["filter_passed"] = passed
    full = [f.result() for f in fields[-1]]
    out["fields"] = {}
    for (name, _, keep), futs in zip(masks, fields):
        got = [f.result() for f in futs]
        for g, f in zip(got, full):
            require(all(g[3][k] == f[3][k] for k in keep),
                    f"leg 13b: {name}'s fields != the full decode's")
        out["fields"][name] = {
            "decode_s": sum(g[0] for g in got),
            "blocks_left_compressed": sum(g[1] for g in got),
            "blocks": sum(g[2] for g in got)}
    texts = [f.result()[1] for f in d_truth]
    require(d["sam"] == b"".join(texts), "leg 13d: SAM != the host chain's")
    require(np.array_equal(d["hist"], d_hist.result()),
            "leg 13d: cram_qual_hist != the host histogram")
    out["check_s"] = time.time() - t0
    return out


# ---------------------------------------------------------------------------
# leg 14: the indexes (index.py, sam/indexing.py, vcf/io.py, tbx.py,
# faidx.py) with their region queries decoded on the card
# ---------------------------------------------------------------------------

def chunk_ranges(chunks, coffsets, ustarts):
    """Each chunk (u, v) of virtual offsets as uncompressed stream offsets
    [u0, u1): a virtual offset's member is found by its compressed offset
    in the file's member table (scan_blocks, the EOF member included), so
    both forms of a member's end, (member, its ISIZE) and (next member,
    0), map to the same offset."""
    at = {int(c): int(u) for c, u in zip(coffsets, ustarts)}
    return [(at[u >> 16] + (u & 0xFFFF), at[v >> 16] + (v & 0xFFFF))
            for u, v in chunks]


def member_table(path: str):
    """(coffsets, csizes, ustarts, usizes) of a BGZF file's members, its
    EOF member included."""
    from htslib_tpu_torch.bgzf import scan_blocks
    bt = scan_blocks(np.fromfile(path, np.uint8))
    return bt.coffsets, bt.csizes, bt.uoffsets, bt.usizes


def leg14_rewrite(src: str, dst: str, unplaced: int = LEG14_UNPLACED):
    """14a's file: leg 10's BAM read back a record at a time by the
    streaming BamReader and written with BamWriter(build_index=True) (its
    .bai beside it), then `unplaced` unmapped, unplaced copies of its
    first records as the tail that HTS_IDX_NOCOOR reads.  Returns (each
    placed record's position, its uncompressed end, records read)."""
    from htslib_tpu_torch.sam.bam import BamReader, BamWriter
    pos, uend, first = [], [], []
    with BamReader(src) as r, BamWriter(dst, r.header, level=BGZF_LEVEL,
                                        build_index=True) as w:
        for rec in r:
            w.write(rec)
            pos.append(rec.pos)
            uend.append(w.fp.utell())
            if len(first) < unplaced:
                first.append(rec)
        for rec in first:
            rec.tid = rec.mtid = rec.pos = rec.mpos = -1
            rec.flag |= 4
            rec.cigar = np.empty(0, np.uint32)
            rec.bin = 4680                          # reg2bin(-1, 0)
            rec.isize = 0
            w.write(rec)
    return np.array(pos, np.int64), np.array(uend, np.int64), len(pos)


def _leg14_bam_index(path: str, out: str, min_shift: int):
    """build_bam_index of `path` into `out`; returns its seconds."""
    from htslib_tpu_torch.sam.indexing import build_bam_index
    t0 = time.time()
    build_bam_index(path, out, min_shift)
    return time.time() - t0


def _leg14_bam_fetch(path: str, idx_path: str, region):
    """Host truth of a 14a region: bam_itr_query's records over the index
    at `idx_path`, formatted by to_sam."""
    from htslib_tpu_torch.sam.bam import BamReader
    from htslib_tpu_torch.sam.indexing import bam_itr_query, load_bam_index
    with BamReader(path) as r:
        idx = load_bam_index(path, idx_path)
        return [rec.to_sam(r.header)
                for rec in bam_itr_query(r, idx, *region)]


def _leg14_bcf(src: str, dst: str, level: int):
    """14b's file: leg 12's BCF read back by BcfReader and written with
    BcfWriter(build_index=True); then bcf_index_build of it, whose .csi
    must be the writer's byte for byte.  Returns (write s, build s,
    records)."""
    from htslib_tpu_torch.vcf.io import BcfReader, BcfWriter, bcf_index_build
    t0 = time.time()
    n = 0
    with BcfReader(src) as r, BcfWriter(dst, r.header, level=level,
                                        build_index=True) as w:
        for rec in r:
            w.write(rec)
            n += 1
    t1 = time.time()
    bcf_index_build(dst, out=dst + ".rebuilt.csi")
    t2 = time.time()
    with open(dst + ".csi", "rb") as a, open(dst + ".rebuilt.csi",
                                              "rb") as b:
        require(a.read() == b.read(), "leg 14b: BcfWriter's .csi != "
                "bcf_index_build's")
    return t1 - t0, t2 - t1, n


def _leg14_bcf_fetch(path: str, region):
    """Host truth of a 14b region: BcfReader.fetch's records as VCF."""
    from htslib_tpu_torch.vcf.io import BcfReader
    with BcfReader(path) as r:
        lines = [rec.to_vcf(r.header) for rec in r.fetch(*region)]
    return ("\n".join(lines) + ("\n" if lines else "")).encode()


def _leg14_tabix(src: str, dst: str, level: int):
    """14c's file: leg 12's VCF text bgzipped, indexed by Tabix.build as
    TBI and as CSI (min_shift 14).  Returns (bgzip s, TBI s, CSI s)."""
    from htslib_tpu_torch.bgzf import BgzfWriter
    from htslib_tpu_torch.tbx import CONF_VCF, Tabix
    t0 = time.time()
    with open(src, "rb") as fp, BgzfWriter(dst, level=level) as w:
        w.write(fp.read())
    t1 = time.time()
    Tabix.build(dst, CONF_VCF)
    t2 = time.time()
    Tabix.build(dst, CONF_VCF, 14)
    return t1 - t0, t2 - t1, time.time() - t2


def _leg14_tabix_fetch(path: str, ext: str, region: str):
    """Host truth of a 14c region: Tabix.query_region's lines over the
    index `path` + `ext`."""
    from htslib_tpu_torch.bgzf import BgzfReader
    from htslib_tpu_torch.tbx import Tabix
    tbx = Tabix.load(path + ext)
    with BgzfReader(path) as fp:
        return list(tbx.query_region(fp, region))


def _leg14_fasta(src: str, dst: str, level: int, seed: int = 14):
    """14d's reference: leg 11's FASTA bgzipped with its .gzi
    (BgzfWriter.save_index); Faidx.fetch_seq over 64 seeded intervals of
    it must equal the plain file's.  Returns (bgzip s, fetch s)."""
    from htslib_tpu_torch.bgzf import BgzfWriter
    from htslib_tpu_torch.faidx import Faidx
    t0 = time.time()
    with open(src, "rb") as fp:
        data = fp.read()
    w = BgzfWriter(dst, level=level)
    w.write(data)
    w.close()
    w.save_index()
    t1 = time.time()
    plain, gz = Faidx.load(src), Faidx.load(dst)
    rng = np.random.default_rng(seed)
    for _ in range(64):
        name = LEG8_REFS[int(rng.integers(0, len(LEG8_REFS)))]
        beg = int(rng.integers(0, plain.seq_len(name)))
        end = beg + int(rng.integers(1, 100_000))
        require(gz.fetch_seq(name, beg, end) == plain.fetch_seq(
            name, beg, end), f"leg 14d: {name}:{beg}-{end} of the .fa.gz")
    plain.close()
    gz.close()
    return t1 - t0, time.time() - t1


def leg14_regions(pos, uend, ustarts, seed: int = 14):
    """14a's N_REGIONS regions (tid, beg, end): one of 1 kb across the
    boundary of the file's middle member (around the first record that
    ends past it), one on the reference with no records, the unplaced
    tail (HTS_IDX_NOCOOR), the rest seeded, 1 kb to 500 kb, on leg 10's
    1 Mbp of chr1."""
    from htslib_tpu_torch.index import HTS_IDX_NOCOOR
    rng = np.random.default_rng(seed)
    i = int(np.searchsorted(uend, ustarts[len(ustarts) // 2],
                            side="right"))
    out = [(0, int(pos[i]) - 500, int(pos[i]) + 500), (1, 0, 500_000),
           (HTS_IDX_NOCOOR, 0, 0)]
    while len(out) < N_REGIONS:
        span = int(np.exp(rng.uniform(np.log(1000), np.log(500_000))))
        beg = int(rng.integers(0, 1_000_000 - span))
        out.append((0, beg, beg + span))
    return out


def leg14_vcf_regions(seed: int):
    """N_REGIONS seeded regions (tid, beg, end) over leg 12's contigs, 1
    kb to 500 kb long, within the span its records take (10,000 bp, then
    N_VCF / 2 steps of 1,000 bp on average a contig)."""
    rng = np.random.default_rng(seed)
    extent = 10_000 + N_VCF * 500
    out = []
    for k in range(N_REGIONS):
        span = int(np.exp(rng.uniform(np.log(1000), np.log(
            min(500_000, extent // 2)))))
        beg = int(rng.integers(0, extent - span))
        out.append((k % len(LEG12_CONTIGS), beg, beg + span))
    return out


def leg14(device, tmp: str, l10_bam: str, l11, l12):
    """Leg 14, the indexes on the card, after leg 10b (whose BAM it
    reads) and legs 11-13.  The host builds run in a pool of processes
    while this process rewrites 14a's BAM and drives the card; the host
    truths are tasks of the same pool.  14a: leg 10's BAM rewritten with
    its .bai (leg14_rewrite); build_bam_index's BAI must equal the
    writer's, and a CSI (min_shift 14) is built too; N_REGIONS regions
    (leg14_regions), each's chunks inflated by bgzf.inflate_range (X4)
    and formatted by bam_payload_to_sam_device (X5, B1), its lines that
    overlap the region (RNAME "*" for the tail) equal to the records of
    bam_itr_query over the BAI and over the CSI, formatted by to_sam.
    14b: leg 12's BCF rewritten with BcfWriter(build_index=True) (its
    .csi equal to bcf_index_build's); regions over both contigs, their
    chunks inflated (X4), framed (split_frames), the frames that overlap
    formatted (format_frames), equal to BcfReader.fetch's records as VCF.
    14c: leg 12's VCF bgzipped and indexed by Tabix.build as TBI and CSI;
    regions inflated (X4), the lines tbx_parse1 places in the region
    equal to Tabix.query_region's over either index.  14d: leg 11's
    FASTA bgzipped with its .gzi; 64 intervals fetched from it equal the
    plain file's; 11a decoded by cram_file_to_sam with ref= the .fa.gz on
    the card (B7, X1, X5, B1) equals 11a's text.  Returns its notes."""
    from htslib_tpu_torch.bgzf import inflate_range
    from htslib_tpu_torch.cram.batch import cram_file_to_sam
    from htslib_tpu_torch.index import HTS_IDX_NOCOOR, HtsIndex
    from htslib_tpu_torch.ops.bam2sam import bam_payload_to_sam_device
    from htslib_tpu_torch.sam.bam import read_header
    from htslib_tpu_torch.tbx import CONF_VCF, Tabix, tbx_parse1
    from htslib_tpu_torch.vcf.io import BcfReader, format_frames, split_frames
    t_leg = time.time()
    notes, truths = {}, {}
    bam = os.path.join(tmp, "leg14.bam")
    bcf = os.path.join(tmp, "leg14.bcf")
    vgz = os.path.join(tmp, "leg14.vcf.gz")
    fgz = os.path.join(tmp, "leg14.fa.gz")
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                             mp_context=ctx) as pool:
        builds = {"b": pool.submit(_leg14_bcf, l12["path"], bcf, BGZF_LEVEL),
                  "c": pool.submit(_leg14_tabix, os.path.join(
                      tmp, "leg12.vcf"), vgz, BGZF_LEVEL),
                  "d": pool.submit(_leg14_fasta, l11["11a"]["ref"], fgz,
                                   BGZF_LEVEL)}
        # 14a: the rewrite here, the BAI and CSI builds in the pool
        t0 = time.time()
        pos, uend, n = leg14_rewrite(l10_bam, bam)
        a = {"records": n, "rewrite_s": time.time() - t0}
        require(n == N_RECORDS, f"leg 14a: {n} records read back")
        bai = pool.submit(_leg14_bam_index, bam, bam + ".rebuilt.bai", 0)
        csi = pool.submit(_leg14_bam_index, bam, bam + ".csi", 14)
        co, cs, us0, us = member_table(bam)
        regions = leg14_regions(pos, uend, us0)
        truths["a.bai"] = [pool.submit(_leg14_bam_fetch, bam, bam + ".bai",
                                       r) for r in regions]
        idx = HtsIndex.load(bam + ".bai")
        hdr = read_header(bam)
        t0 = time.time()
        a["regions"] = []
        for tid, beg, end in regions:
            if tid == HTS_IDX_NOCOOR:
                chunks = [(idx.nocoor_offset(), int(co[-1]) << 16)]
            else:
                chunks = idx.query_chunks(tid, beg, end)
            lines = []
            for u0, u1 in chunk_ranges(chunks, co, us0):
                payload = inflate_range(bam, co, cs, us0, us, u0, u1, device)
                text = bam_payload_to_sam_device(payload, hdr, device=device)
                lines += text.decode().splitlines()
            if tid == HTS_IDX_NOCOOR:
                lines = [ln for ln in lines if ln.split("\t", 3)[2] == "*"]
            else:
                lines = [ln for ln in lines if sam_overlaps(
                    ln, hdr.tid2name(tid), beg, end)]
            a["regions"].append({"region": (tid, beg, end),
                                 "chunks": chunks, "lines": lines})
        a["card_s"] = time.time() - t0
        a["ms_a_region"] = a["card_s"] / len(regions) * 1e3
        require(a["regions"][0]["chunks"][0][0] >> 16
                < int(co[len(co) // 2]) <= a["regions"][0]["chunks"][-1][1]
                >> 16, "leg 14a: region 0 does not cross the middle member")
        a["bai_build_s"], a["csi_build_s"] = bai.result(), csi.result()
        truths["a.csi"] = [pool.submit(_leg14_bam_fetch, bam, bam + ".csi",
                                       r) for r in regions]
        with open(bam + ".bai", "rb") as x, open(bam + ".rebuilt.bai",
                                                  "rb") as y:
            require(x.read() == y.read(), "leg 14a: BamWriter's .bai != "
                    "build_bam_index's")
        notes["14a"] = a

        # 14b: regions of the rewritten BCF through its .csi
        b = dict(zip(("write_s", "index_build_s", "records"),
                     builds["b"].result()))
        vregions = leg14_vcf_regions(15)
        truths["b"] = [pool.submit(_leg14_bcf_fetch, bcf, r)
                       for r in vregions]
        co, cs, us0, us = member_table(bcf)
        idx = HtsIndex.load(bcf + ".csi")
        with BcfReader(bcf) as r:
            vhdr = r.header
        t0 = time.time()
        b["regions"] = []
        for rid, beg, end in vregions:
            keep_s, keep_i = [], []
            for u0, u1 in chunk_ranges(idx.query_chunks(rid, beg, end), co,
                                       us0):
                shared, indiv = split_frames(inflate_range(
                    bcf, co, cs, us0, us, u0, u1, device))
                for s, i in zip(shared, indiv):
                    r_rid, r_pos, r_len = struct.unpack_from("<iii", s)
                    if r_rid == rid and r_pos < end and r_pos + max(
                            r_len, 1) > beg:
                        keep_s.append(s)
                        keep_i.append(i)
            b["regions"].append({"region": (rid, beg, end), "text":
                                 format_frames(keep_s, keep_i, vhdr)})
        b["card_s"] = time.time() - t0
        b["ms_a_region"] = b["card_s"] / len(vregions) * 1e3
        notes["14b"] = b

        # 14c: the bgzipped VCF's regions through its TBI
        c = dict(zip(("bgzip_s", "tbi_build_s", "csi_build_s"),
                     builds["c"].result()))
        tbx = Tabix.load(vgz + ".tbi")
        cregions = [(LEG12_CONTIGS[t][0], b0, e0)
                    for t, b0, e0 in leg14_vcf_regions(16)]
        for ext in (".tbi", ".csi"):
            truths["c" + ext] = [pool.submit(
                _leg14_tabix_fetch, vgz, ext, f"{name}:{b0 + 1}-{e0}")
                for name, b0, e0 in cregions]
        co, cs, us0, us = member_table(vgz)
        t0 = time.time()
        c["regions"] = []
        for name, beg, end in cregions:
            lines = []
            for u0, u1 in chunk_ranges(tbx.idx.query_chunks(
                    tbx.name2tid(name), beg, end), co, us0):
                for ln in inflate_range(vgz, co, cs, us0, us, u0, u1,
                                        device).decode().splitlines():
                    p = tbx_parse1(CONF_VCF, ln)
                    if p and p[0] == name and p[1] < end and p[2] > beg:
                        lines.append(ln)
            c["regions"].append({"region": (name, beg, end),
                                 "lines": lines})
        c["card_s"] = time.time() - t0
        c["ms_a_region"] = c["card_s"] / len(cregions) * 1e3
        notes["14c"] = c

        # 14d: 11a decoded against the bgzipped FASTA
        d = dict(zip(("bgzip_s", "fetch_s"), builds["d"].result()))
        timing = {}
        t0 = time.time()
        _, sam = cram_file_to_sam(l11["11a"]["path"], ref=fgz, device=device,
                                  timing=timing)
        d["decode_s"] = time.time() - t0
        d["parts"] = {k: v for k, v in timing.items()
                      if k not in ("wires", "format")}
        require(sam.tobytes() == l11["11a"]["sam"], "leg 14d: 11a by the "
                ".fa.gz != 11a's text")
        notes["14d"] = d

        # the truths
        t0 = time.time()
        for ext in (".bai", ".csi"):
            for r, fut in zip(a["regions"], truths["a" + ext]):
                require(r["lines"] == fut.result(), f"leg 14a: region "
                        f"{r['region']}'s lines != bam_itr_query's ({ext})")
        for r, fut in zip(b["regions"], truths["b"]):
            require(r["text"] == fut.result(), f"leg 14b: region "
                    f"{r['region']}'s text != BcfReader.fetch's")
        for ext in (".tbi", ".csi"):
            for r, fut in zip(c["regions"], truths["c" + ext]):
                require(r["lines"] == fut.result(), f"leg 14c: region "
                        f"{r['region']}'s lines != query_region's ({ext})")
        check = {"truth_wait_s": time.time() - t0,
                 "14a_lines": [len(r["lines"]) for r in a["regions"]],
                 "14b_records": [r["text"].count(b"\n")
                                 for r in b["regions"]],
                 "14c_lines": [len(r["lines"]) for r in c["regions"]]}
    require(check["14a_lines"][1] == 0 and check["14a_lines"][2]
            == LEG14_UNPLACED and all(check["14a_lines"][3:]),
            f"leg 14a: region records {check['14a_lines']}")
    require(sum(map(bool, check["14b_records"])) > N_REGIONS // 2
            and sum(map(bool, check["14c_lines"])) > N_REGIONS // 2,
            f"leg 14b/c: regions hit {check}")
    # 14c's lines, which leg 17's tabix queries must give again
    notes["14c_lines"] = [r["lines"] for r in c["regions"]]
    for part in (a, b, c):
        for r in part["regions"]:
            for k in ("lines", "text", "chunks"):
                r.pop(k, None)
    notes["check"] = check
    notes["wall_s"] = time.time() - t_leg
    return notes


def leg15_reads(n: int = LEG15_READS, length: int = LEG15_READ_LEN,
                seed: int = 15):
    """15e's reads: n Illumina-style reads of `length` bases in pairs (the
    names of a HiSeq run, /1 and /2), qualities from a seeded model (a
    per-cycle mean falling from 38 to 28 along the read, Gaussian noise,
    5% of the reads ending in a Q2 tail), bases uniform, N at Q2.  Returns
    (QNAMEs as bytes, FLAGs, bases uint8 [n, length], phred uint8
    [n, length])."""
    rng = np.random.default_rng(seed)
    cycle = np.arange(length)
    mean = 38.0 - 10.0 * (cycle / length) ** 2
    qual = np.clip(np.rint(mean + rng.normal(0, 3, (n, length))), 2,
                   41).astype(np.uint8)
    tail = rng.random(n) < 0.05
    start = rng.integers(length // 2, length, n)
    qual[tail[:, None] & (cycle[None, :] >= start[:, None])] = 2
    bases = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (n, length))]
    bases[qual == 2] = ord("N")
    names = [b"HWI-ST1234:8:FC706VJ:2:%d:%d:%d" % (1101 + (i // 2) % 16,
                                                    1000 + (i // 2) % 20000,
                                                    i // 2)
             for i in range(n)]
    flags = np.where(np.arange(n) % 2 == 0, 77, 141)
    return names, flags, bases, qual


def leg15_fastq_text(reads) -> bytes:
    """leg15_reads as FASTQ: each name with its /1 or /2 and a CASAVA
    comment (read number, N, 0, one of four barcodes)."""
    names, flags, bases, qual = reads
    codes = [b"ATCACG", b"CGATGT", b"TTAGGC", b"TGACCA"]
    phred = qual + 33
    return b"".join(
        b"@%s/%d %d:N:0:%s\n%s\n+\n%s\n" % (
            names[i], 1 + i % 2, 1 + i % 2, codes[(i // 2) % 4],
            bases[i].tobytes(), phred[i].tobytes())
        for i in range(len(names)))


def _leg15_import(fq: str, bam: str, n: int):
    """15e on the host: leg15_reads(n) written as bgzipped FASTQ, read
    back through hts_open (a FastxReader) and written as BAM through
    hts_open(bam, "wb").  Returns (seconds by part, and the summary
    _leg15_open(fq, "fastq", True) gives, from the same pass)."""
    from htslib_tpu_torch.bgzf import BgzfWriter
    from htslib_tpu_torch.hts import hts_open
    from htslib_tpu_torch.sam.fastq import FastxReader
    t0 = time.time()
    text = leg15_fastq_text(leg15_reads(n))
    t1 = time.time()
    with BgzfWriter(fq, level=BGZF_LEVEL) as w:
        w.write(text)
    t2 = time.time()
    r = hts_open(fq)
    require(isinstance(r, FastxReader), f"15e: hts_open gave {r}")
    w = hts_open(bam, "wb", header=r.header)
    first = last = None
    count = 0
    for rec in r:
        w.write(rec)
        first = rec if first is None else first
        last = rec
        count += 1
    w.close()
    r.close()
    return {"make_s": t1 - t0, "bgzip_s": t2 - t1,
            "read_write_s": time.time() - t2, "fastq_bytes": len(text),
            "bam_bytes": os.path.getsize(bam)}, (
        type(r).__name__, count, first.to_sam(r.header),
        last.to_sam(r.header))


def _leg15_sam_to_bam(text: bytes, header_text: str, out: str):
    """15f on the host: sam_to_bam_file (pipeline_map's threads).
    Returns (uncompressed bytes written, seconds)."""
    from htslib_tpu_torch.sam.batch import sam_to_bam_file
    from htslib_tpu_torch.sam.header import SamHeader
    t0 = time.time()
    n = sam_to_bam_file(text, SamHeader(header_text), out, level=BGZF_LEVEL)
    return n, time.time() - t0


def _leg15_open(path: str, kind: str, by_hts: bool):
    """15d: the file opened by hts_open (by_hts) or by its format's own
    reader.  Returns ((the reader's class name, records, first and last
    records' text: SAM, or VCF for variant data), seconds)."""
    from htslib_tpu_torch.hts import hts_open
    from htslib_tpu_torch.sam.bam import BamReader
    from htslib_tpu_torch.sam.fastq import FastxReader
    from htslib_tpu_torch.vcf.io import BcfReader, VcfReader
    t0 = time.time()
    if by_hts:
        r = hts_open(path)
    else:
        r = {"bam": lambda: BamReader(path),
             "bcf": lambda: BcfReader(path), "vcf": lambda: VcfReader(path),
             "fasta": lambda: FastxReader(path, fasta=True),
             "fastq": lambda: FastxReader(path)}[kind]()
    first = last = None
    count = 0
    with r:
        for rec in r:
            if first is None:
                first = rec
            last = rec
            count += 1
        texts = [x.to_vcf(r.header) if kind in ("bcf", "vcf")
                 else x.to_sam(r.header) for x in (first, last)]
    return (type(r).__name__, count, texts[0], texts[1]), time.time() - t0


def cram_containers(path: str):
    """(offset, records) of every data container of a CRAM file, from
    its container headers."""
    from htslib_tpu_torch.cram import CRAM_EOF_START
    from htslib_tpu_torch.cram.io import CramIO, read_file_definition
    out = []
    with open(path, "rb") as fp:
        io_ = CramIO(fp, read_file_definition(fp)[0])
        c = io_.read_container_header()
        while True:
            fp.seek(c.data_offset + c.length)
            c = io_.read_container_header()
            if c is None or (c.ref_seq_id == -1
                             and c.ref_seq_start == CRAM_EOF_START):
                return out
            if c.num_records:
                out.append((c.offset, c.num_records))


def _leg15_cram_part(path: str, ref, offset: int, n: int, last: bool,
                     by_hts: bool):
    """15d over one container of a CRAM (its host decode costs seconds,
    so a reader's pass runs a container a process): the reader hts_open
    gives (by_hts) or a CramReader, seeked to the container at `offset`,
    must give its `n` records, then, where it is the `last`, none.
    Returns ((the class name, n, first and last records' SAM text),
    seconds)."""
    from htslib_tpu_torch.cram import CramReader
    from htslib_tpu_torch.hts import hts_open
    t0 = time.time()
    r = hts_open(path, ref=ref) if by_hts else CramReader(path, ref=ref)
    with r:
        r.fp.seek(offset)
        recs = [r.read1() for _ in range(n)]
        require(all(recs) and (not last or r.read1() is None),
                f"15d: the container at {offset} of {path}")
        texts = [x.to_sam(r.header) for x in (recs[0], recs[-1])]
    return (type(r).__name__, n, texts[0], texts[1]), time.time() - t0


def _leg15_writers(src: str, ref: str, tmp: str):
    """15d's writers: the first LEG15_WRITE records of `src` (11a's CRAM,
    read by hts_open) written by hts_open's mode letters, "wb" with
    level=1, "wc" with seqs_per_slice=2000 and the reference, "wz", each
    file read back by hts_open: the reader's class and every record's
    SAM line must be the source's.  Returns {mode: (class, records,
    bytes, write s)}."""
    from htslib_tpu_torch.hts import hts_open
    with hts_open(src, ref=ref) as r:
        hdr = r.header
        recs = []
        for rec in r:
            recs.append(rec)
            if len(recs) == LEG15_WRITE:
                break
    want = [rec.to_sam(hdr) for rec in recs]
    out = {}
    for mode, opts, ext, cls in (
            ("wb", ["level=1"], "bam", "BamReader"),
            ("wc", ["seqs_per_slice=2000", f"reference={ref}"], "cram",
             "CramReader"),
            ("wz", [], "sam.gz", "SamReader")):
        path = os.path.join(tmp, f"leg15.{ext}")
        t0 = time.time()
        w = hts_open(path, mode, header=hdr, opts=opts)
        for rec in recs:
            w.write(rec)
        w.close()
        secs = time.time() - t0
        with hts_open(path, ref=ref) as r:
            require(type(r).__name__ == cls, f"15d {mode}: read back by "
                    f"{type(r).__name__}")
            got = [rec.to_sam(r.header) for rec in r]
        require(got == want, f"15d {mode}: records read back differ")
        out[mode] = (cls, len(got), os.path.getsize(path), secs)
    return out


def leg15(device, tmp: str, l10_bam: str, chain_sam: bytes,
          varied_sam: bytes, l11, l12):
    """Leg 15, the I/O layer and the file-level entry points on the card,
    after leg 14, on the files legs 10-14 made; the host work runs in a
    pool of processes while the card works.  15a: bam_file_to_sam on leg
    10's BAM (X4, X5, B1) must equal leg 8's text.  15b: the same file
    from a RangeServer on 127.0.0.1 through HttpFile, and from an
    htsget+http ticket of LEG15_PARTS Range parts and the EOF member
    inline, each equal to 15a's text; hts_open on the URL a BamReader
    whose first LEG15_FIRST lines are leg 8's.  15c: 11a's CRAM decoded
    by cram_file_to_sam on the card with its FASTA moved away and
    REF_PATH a URL template the server answers by M5 (B7, X1, X5, B1):
    11a's text.  15d: hts_open on every file of legs 10-14 and 15e's
    FASTQ gives the reader of its format, with the records, first and
    last, of the format's own reader (_leg15_open; _leg15_cram_part a
    container a process for the CRAMs); writers by mode
    letters read back the records (_leg15_writers).  15e: LEG15_READS
    reads imported from bgzipped FASTQ to BAM by hts_open
    (_leg15_import), then bam_file_to_sam on the card: every line's
    QNAME, FLAG, SEQ and QUAL the read's.  15f: leg 8's varied text
    written by sam_to_bam_file (pipeline_map), then bam_file_to_sam on
    the card gives it back.  Returns its notes."""
    import shutil

    from htslib_tpu_torch.cram.batch import cram_file_to_sam
    from htslib_tpu_torch.faidx import Faidx
    from htslib_tpu_torch.hts import hts_open
    from htslib_tpu_torch.sam.bam import BamReader
    from htslib_tpu_torch.sam.batch import bam_file_to_sam
    t_leg = time.time()
    notes = {}
    fasta = l11["11a"]["ref"]
    ref = os.path.join(tmp, "leg15_ref.fa")       # the pool's copy
    shutil.copy(fasta, ref)
    shutil.copy(fasta + ".fai", ref + ".fai")
    fq, fq_bam = (os.path.join(tmp, "leg15.fq.gz"),
                  os.path.join(tmp, "leg15_fq.bam"))
    f_bam = os.path.join(tmp, "leg15_varied.bam")
    files = {"bam": l10_bam, "cram30": l11["11a"]["path"],
             "cram31": l11["11b"]["path"], "bcf": l12["path"],
             "vcf.gz": os.path.join(tmp, "leg14.vcf.gz"),
             "fa.gz": os.path.join(tmp, "leg14.fa.gz")}
    kinds = {"bam": "bam", "bcf": "bcf", "vcf.gz": "vcf", "fa.gz": "fasta"}
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                             mp_context=ctx) as pool:
        # the longest host tasks first: the CRAM containers' host
        # decode (the pure-Python rANS, 5-10 s a container), the writers
        # (which decode 11a's first container), the VCF parse (about half
        # a millisecond a record of 32 samples), the import
        parts = {(name, by): [pool.submit(
            _leg15_cram_part, files[name], ref if name == "cram30" else
            None, off, n, k == len(conts) - 1, by)
            for k, (off, n) in enumerate(conts)]
            for name, conts in (("cram30", cram_containers(files["cram30"])),
                                ("cram31", cram_containers(files["cram31"])))
            for by in (True, False)}
        writers = pool.submit(_leg15_writers, files["cram30"], ref, tmp)
        opens = {("vcf.gz", by): pool.submit(_leg15_open, files["vcf.gz"],
                                             "vcf", by)
                 for by in (True, False)}
        imp = pool.submit(_leg15_import, fq, fq_bam, LEG15_READS)
        s2b = pool.submit(_leg15_sam_to_bam, varied_sam, "".join(
            f"@SQ\tSN:{r}\tLN:300000000\n" for r in LEG8_REFS), f_bam)
        opens.update({(name, by): pool.submit(_leg15_open, files[name],
                                              kinds[name], by)
                      for name in ("bam", "bcf", "fa.gz")
                      for by in (True, False)})

        # 15a: the BAM file on the card
        timing = {}
        t0 = time.time()
        _, text = bam_file_to_sam(l10_bam, device=device, timing=timing)
        wall = time.time() - t0
        text = text.tobytes()
        require(text == chain_sam, "15a: bam_file_to_sam != leg 8's text")
        notes["15a"] = {"wall_s": wall, "sam_MBps": len(text) / wall / 1e6,
                        "bam_bytes": os.path.getsize(l10_bam),
                        "sam_bytes": len(text), "parts": timing}

        # 15b and 15c: one server on 127.0.0.1
        m5s = {}
        fai = Faidx.load(fasta)
        for ln in cram_header(files["cram30"]).lines:
            if ln.type == "SQ":
                m5s["/m5/" + ln.get("M5")] = fai.fetch_seq(
                    ln.get("SN")).encode().upper()
        fai.close()
        with RangeServer(tmp, m5s) as srv:
            size = os.path.getsize(l10_bam)
            with open(l10_bam, "rb") as fp:
                fp.seek(size - 28)
                eof = fp.read()
            srv.extra["/tickets/leg10"] = htsget_ticket(
                srv.url("leg10.bam"), size - 28, LEG15_PARTS, eof)
            b = {}
            for tag, url in (("http", srv.url("leg10.bam")), (
                    "htsget", f"htsget+http://127.0.0.1:{srv.port}/tickets/"
                    "leg10")):
                n0 = len(srv.requests)
                t0 = time.time()
                _, got = bam_file_to_sam(url, device=device)
                wall = time.time() - t0
                require(got.tobytes() == text, f"15b {tag}: != 15a's text")
                b[tag] = {"wall_s": wall, "sam_MBps": len(text) / wall / 1e6,
                          "requests": len(srv.requests) - n0}
            require(b["http"]["requests"] == 1
                    and b["htsget"]["requests"] == 1 + LEG15_PARTS,
                    f"15b: requests {b}")
            t0 = time.time()
            with hts_open(srv.url("leg10.bam")) as r:
                require(isinstance(r, BamReader), f"15b: hts_open gave {r}")
                first = [r.read1().to_sam(r.header)
                         for _ in range(LEG15_FIRST)]
            b["hts_open_first_s"] = time.time() - t0
            require(first == [ln.decode() for ln in chain_sam.split(
                b"\n", LEG15_FIRST)[:LEG15_FIRST]],
                "15b: hts_open's first records != leg 8's lines")
            notes["15b"] = b

            # 15c: 11a by REF_PATH URL, its FASTA moved away
            moved = fasta + ".moved"
            saved = {k: os.environ.get(k) for k in ("REF_CACHE", "REF_PATH")}
            os.rename(fasta, moved)
            try:
                for k in saved:
                    os.environ.pop(k, None)
                os.environ["REF_PATH"] = srv.url("m5/%s")
                n0 = len(srv.requests)
                timing = {}
                t0 = time.time()
                _, sam = cram_file_to_sam(files["cram30"], device=device,
                                          timing=timing)
                c = {"wall_s": time.time() - t0,
                     "requests": sorted(p for p, *_ in srv.requests[n0:]),
                     "parts": {k: v for k, v in timing.items()
                               if k not in ("wires", "format")}}
            finally:
                os.rename(moved, fasta)
                for k, v in saved.items():
                    os.environ.pop(k, None)
                    if v is not None:
                        os.environ[k] = v
            require(sam.tobytes() == l11["11a"]["sam"],
                    "15c: 11a by REF_PATH URL != 11a's text")
            require(c["requests"] == sorted(m5s), f"15c: fetched {c}")
            notes["15c"] = c

        # 15e: the FASTQ import, decoded on the card
        e, fq_open = imp.result()
        require(fq_open[1] == LEG15_READS, f"15e: {fq_open[1]} reads "
                "imported")
        opens[("fq.gz", False)] = pool.submit(_leg15_open, fq, "fastq",
                                              False)
        t0 = time.time()
        _, got = bam_file_to_sam(fq_bam, device=device)
        e["decode_s"] = time.time() - t0
        names, flags, bases, qual = leg15_reads(LEG15_READS)
        lines = got.tobytes().split(b"\n")
        require(len(lines) == LEG15_READS + 1 and lines[-1] == b"",
                "15e: line count")
        cols = [ln.split(b"\t", 11) for ln in lines[:-1]]
        require([c[0] for c in cols] == names, "15e: QNAMEs")
        require([int(c[1]) for c in cols] == flags.tolist(), "15e: FLAGs")
        require(b"".join(c[9] for c in cols) == bases.tobytes(), "15e: SEQ")
        require(b"".join(c[10] for c in cols) == (qual + 33).tobytes(),
                "15e: QUAL")
        e["sam_MBps"] = len(got) / e["decode_s"] / 1e6
        notes["15e"] = e

        # 15f: SAM -> BAM by sam_to_bam_file, back on the card
        written, secs = s2b.result()
        t0 = time.time()
        _, got = bam_file_to_sam(f_bam, device=device)
        notes["15f"] = {"sam_to_bam_s": secs, "written": written,
                        "bam_bytes": os.path.getsize(f_bam),
                        "decode_s": time.time() - t0}
        require(got.tobytes() == varied_sam, "15f: the text back != leg 8's")

        # 15d: the truths of the pool, each a (summary, seconds); a CRAM
        # reader's pass is its containers' parts, summed
        t0 = time.time()
        summ = {key: fut.result() for key, fut in opens.items()}
        for key, futs in parts.items():
            got = [f.result() for f in futs]
            require(len({g[0][0] for g in got}) == 1, f"15d {key}: {got}")
            summ[key] = ((got[0][0][0], sum(g[0][1] for g in got),
                          got[0][0][2], got[-1][0][3]),
                         max(g[1] for g in got))
        summ[("fq.gz", True)] = (fq_open, e["read_write_s"])
        d = {}
        for name in list(files) + ["fq.gz"]:
            (ours, ours_s), (direct, direct_s) = (summ[(name, True)],
                                                  summ[(name, False)])
            require(ours == direct, f"15d {name}: hts_open's reader "
                    f"{ours[:2]} != the direct reader's {direct[:2]}")
            d[name] = ours[:2] + (ours_s, direct_s)
        want = {"bam": "BamReader", "cram30": "CramReader",
                "cram31": "CramReader", "bcf": "BcfReader",
                "vcf.gz": "VcfReader", "fa.gz": "FastxReader",
                "fq.gz": "FastxReader"}
        require({k: v[0] for k, v in d.items()} == want, f"15d: {d}")
        require(d["bam"][1] == N_RECORDS and d["cram30"][1] == N_CRAM
                and d["bcf"][1] == d["vcf.gz"][1] == N_VCF
                and d["fq.gz"][1] == LEG15_READS, f"15d: counts {d}")
        notes["15d"] = {"readers": d, "writers": writers.result(),
                        "truth_wait_s": time.time() - t0}
    notes["wall_s"] = time.time() - t_leg
    return notes


def leg16_records(contigs=LEG16_CONTIGS, depth: int = LEG16_DEPTH,
                  length: int = LEG16_READ_LEN, seed: int = 16):
    """Leg 16's reads: 2 x `length` bp pairs at `depth`x over `contigs`
    (name, length), coordinate-sorted, from a seeded random reference
    with 1% substitutions.  Fragments run 150-500 bp (150 + 350 u^2, so
    about a third are shorter than two reads and their mates overlap);
    10% of reads carry a 1-5 bp insertion or deletion, 5% a 1-20 bp soft
    clip; 2% are duplicates, 1% secondary, 1% QC-fail and 0.5% unmapped
    with a placed mate (which loses its proper-pair flag); qualities
    2-40, MAPQ 0-60.  Drawn in bulk with numpy.  Returns (SamHeader,
    records)."""
    from htslib_tpu_torch.sam.header import SamHeader
    from htslib_tpu_torch.sam.record import BamRecord
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    nt16 = np.zeros(256, np.uint8)
    nt16[acgt] = [1, 2, 4, 8]
    header = SamHeader("@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{name}\tLN:{ln}\n" for name, ln in contigs))
    out = []
    pair0 = 0
    for tid, (_, ln) in enumerate(contigs):
        ref = acgt[rng.integers(0, 4, ln + 1000)]
        n_pairs = ln * depth // (2 * length)
        n = 2 * n_pairs
        frag = 150 + (350 * rng.random(n_pairs) ** 2).astype(np.int64)
        left = (rng.random(n_pairs) * (ln - frag)).astype(np.int64)
        pr = np.repeat(np.arange(n_pairs), 2)
        side = np.tile([0, 1], n_pairs)
        # 1: insertion, 2: deletion, 3: clip at the start, 4: at the end
        r = rng.random(n)
        kind = np.select([r < 0.05, r < 0.10, r < 0.125, r < 0.15],
                         [1, 2, 3, 4], 0)
        a = rng.integers(10, length - 10, n)
        k = rng.integers(1, 6, n)
        c = rng.integers(1, 21, n)
        span = np.select([kind == 1, kind == 2, kind >= 3],
                         [length - k, length + k, length - c], length)
        pos = np.where(side == 0, left[pr], left[pr] + frag[pr] - span)
        q = np.arange(length)[None, :]
        A, K, C, kd = a[:, None], k[:, None], c[:, None], kind[:, None]
        off = np.broadcast_to(q, (n, length)).astype(np.int64)
        off = np.where((kd == 1) & (q >= A), np.where(q < A + K, -1, q - K),
                       off)
        off = np.where((kd == 2) & (q >= A), q + K, off)
        off = np.where(kd == 3, np.where(q < C, -1, q - C), off)
        off = np.where((kd == 4) & (q >= length - C), -1, off)
        seq = np.where(off >= 0, ref[pos[:, None] + np.maximum(off, 0)],
                       acgt[rng.integers(0, 4, (n, length))])
        err = rng.random((n, length)) < 0.01
        seq = np.where(err, acgt[rng.integers(0, 4, (n, length))], seq)
        codes = nt16[seq]
        packed = (codes[:, 0::2] << 4) | codes[:, 1::2]
        qual = rng.integers(2, 41, (n, length)).astype(np.uint8)
        mapq = rng.integers(0, 61, n)
        first_left = (rng.random(n_pairs) < 0.5)[pr]
        flag = (0x1 | 0x2 | np.where(side == 0, 0x20, 0x10)
                | np.where((side == 0) == first_left, 0x40, 0x80))
        r = rng.random(n)
        flag |= np.select([r < 0.02, r < 0.03, r < 0.04],
                          [0x400, 0x100, 0x200], 0)
        isize = np.where(side == 0, frag[pr], -frag[pr])
        mpos = pos.reshape(-1, 2)[:, ::-1].reshape(-1).copy()
        # one mate of 1% of pairs (0.5% of reads) unmapped, placed at its
        # mate
        lost_pair = np.flatnonzero(rng.random(n_pairs) < 0.01)
        lost = 2 * lost_pair + (rng.random(len(lost_pair)) < 0.5)
        kept = lost ^ 1
        unmapped = np.zeros(n, bool)
        unmapped[lost] = True
        flag[lost] = ((flag[lost] & ~0x32) | 0x4
                      | np.where(flag[kept] & 0x10, 0x20, 0))
        pos[lost], mapq[lost], isize[lost] = pos[kept], 0, 0
        flag[kept] = (flag[kept] & ~0x22) | 0x8
        mpos[kept], isize[kept] = pos[kept], 0
        # each read's CIGAR ops, 3 a read, 0-length ops dropped
        ops = np.zeros((n, 3), np.uint32)
        ops[:, 0] = length << 4
        for kk, row in ((1, (a << 4, k << 4 | 1, (length - a - k) << 4)),
                        (2, (a << 4, k << 4 | 2, (length - a) << 4)),
                        (3, (c << 4 | 4, (length - c) << 4, 0 * c)),
                        (4, ((length - c) << 4, c << 4 | 4, 0 * c))):
            m = kind == kk
            ops[m] = np.stack(row, 1)[m]
        n_ops = np.select([unmapped, kind == 0, kind >= 3], [0, 1, 2], 3)
        end = np.where(unmapped, pos + 1, pos + span)
        bins = reg2bin(pos, end)
        for i in np.argsort(pos, kind="stable").tolist():
            b = BamRecord()
            b.qname = b"L16:%d" % (pair0 + pr[i])
            b.tid = b.mtid = tid
            b.pos, b.mpos, b.isize = int(pos[i]), int(mpos[i]), int(isize[i])
            b.mapq, b.flag, b.bin = int(mapq[i]), int(flag[i]), int(bins[i])
            b.cigar = ops[i, :n_ops[i]]
            b.seq4, b.l_qseq, b.qual = packed[i].tobytes(), length, \
                qual[i].tobytes()
            out.append(b)
        pair0 += n_pairs
    return header, out


def write_leg16_files(tmp: str, contigs=LEG16_CONTIGS,
                      level: int = BGZF_LEVEL, small: int = LEG16_SMALL):
    """Leg 16's inputs under `tmp`: leg16_records as a BAM deflated at
    `level` by the port's BamWriter ("bam"), its first `small` records
    as a BAM of their own ("small_bam") and as SAM text ("small_sam").
    Returns the paths and the record count."""
    from htslib_tpu_torch.sam.bam import BamWriter
    header, recs = leg16_records(contigs)
    paths = {k: os.path.join(tmp, f) for k, f in (
        ("bam", "leg16.bam"), ("small_bam", "leg16_small.bam"),
        ("small_sam", "leg16_small.sam"))}
    for key, part in (("bam", recs), ("small_bam", recs[:small])):
        with BamWriter(paths[key], header, level=level) as w:
            for b in part:
                w.write(b)
    with open(paths["small_sam"], "w") as fp:
        fp.write(header.text)
        for b in recs[:small]:
            fp.write(b.to_sam(header) + "\n")
    paths["records"] = len(recs)
    return paths


def _zlib_stream(path: str):
    """A BAM file's header length and its record stream, every member
    inflated by zlib on the host, with the members' uncompressed
    sizes."""
    from htslib_tpu_torch.sam.bam import read_bam_header
    raw = open(path, "rb").read()
    pieces, at = [], 0
    while at < len(raw):
        bsize = struct.unpack_from("<H", raw, at + 16)[0] + 1
        pieces.append(zlib.decompress(raw[at + 18:at + bsize - 8], -15))
        at += bsize
    whole = b"".join(pieces)
    bio = io.BytesIO(whole)
    read_bam_header(bio)
    return bio.tell(), whole[bio.tell():], [len(p) for p in pieces]


def stream_fields(stream: bytes) -> dict:
    """The pileup's columns of a record stream by the host, in numpy:
    the u32 walk's offsets and sizes, then each record's tid, pos, end
    (bam_endpos), flag, l_qseq and the offset of its packed sequence
    ("seq_at")."""
    offs, at = [], 0
    while at + 4 <= len(stream):
        offs.append(at)
        at += 4 + int.from_bytes(stream[at:at + 4], "little")
    o = np.array(offs, np.int64)
    pl = np.frombuffer(stream, np.uint8)
    core = pl[o[:, None] + 4 + np.arange(32)].astype(np.int64)

    def le(a, b):
        return sum(core[:, a + i] << (8 * i) for i in range(b - a))
    tid, pos = le(0, 4), le(4, 8)
    tid = np.where(tid >= 1 << 31, tid - (1 << 32), tid)
    pos = np.where(pos >= 1 << 31, pos - (1 << 32), pos)
    n_cig, flag, l_qseq = le(12, 14), le(14, 16), le(16, 20)
    rec = np.repeat(np.arange(len(o)), n_cig)
    k = np.arange(len(rec)) - np.repeat(np.cumsum(n_cig) - n_cig, n_cig)
    op_at = (o + 36 + core[:, 8])[rec] + 4 * k
    word = sum(pl[op_at + i].astype(np.int64) << (8 * i) for i in range(4))
    ref_op = np.isin(word & 0xF, (0, 2, 3, 7, 8))
    span = np.bincount(rec, np.where(ref_op, word >> 4, 0),
                       len(o)).astype(np.int64)
    span = np.where(flag & 4, 0, span)
    return {"offs": o, "sizes": np.diff(np.append(o, len(stream))) - 4,
            "tid": tid, "pos": pos, "end": pos + np.where(span > 0, span, 1),
            "flag": flag, "l_qseq": l_qseq,
            "seq_at": o + 36 + core[:, 8] + 4 * n_cig}


def packed_seqs(stream: bytes, rs: dict) -> np.ndarray:
    """Every record's packed sequence (ceil(l_qseq / 2) bytes) laid end to
    end, gathered from the stream by `stream_fields`' columns: B1's input
    in `decode_records`."""
    plen = (rs["l_qseq"] + 1) // 2
    at = np.repeat(rs["seq_at"] - (np.cumsum(plen) - plen), plen)
    return np.frombuffer(stream, np.uint8)[at + np.arange(len(at))]


def _leg16_host_truth(path: str, nthreads: int):
    """16a's truths from the host: the zlib record stream (with the
    members' sizes and the header's length), the host walk's offsets and
    sizes, the bases by the host decode, and the tile plan from the
    host's fields.  Returns them and the seconds they took."""
    from htslib_tpu_torch.pileup import DEFAULT_SKIP, plan_tiles
    t0 = time.time()
    head, stream, usizes = _zlib_stream(path)
    rs = stream_fields(stream)
    bases = nt16_numpy(packed_seqs(stream, rs)[None, :]).tobytes()
    tiles, _ = plan_tiles(rs, nthreads, DEFAULT_SKIP)
    return ({"stream": stream, "head": head, "usizes": usizes,
             "offs": rs["offs"], "sizes": rs["sizes"],
             "bases_sha": hashlib.sha256(bases).hexdigest(),
             "tiles": tiles}, time.time() - t0)


def _engine_lines(names, recs, lo=(-1, -1), hi=(1 << 40, 0)) -> bytes:
    """The port's engine over `recs` (overlaps on), its columns with lo
    <= (tid, pos) < hi in the test/pileup.c format."""
    from htslib_tpu_torch.pileup import Pileup, _format_plp_column
    from htslib_tpu_torch.sam.header import SamHeader
    header = SamHeader(ref_names=names)
    it = iter(list(recs) + [None])
    lines = []
    for tid, pos, col in Pileup(lambda: next(it), overlaps=True):
        if (tid, pos) >= hi:
            break
        if (tid, pos) >= lo:
            lines.append(_format_plp_column(header, tid, pos, col))
    return ("\n".join(lines) + ("\n" if lines else "")).encode()


def _leg16_window(path: str, nthreads: int, k: int, half: int):
    """The serial engine over the reads (inflated by zlib, parsed by
    BamRecord on the host) that overlap the `half`-wide window either
    side of the k-th tile boundary of the plan from host fields
    (`stream_fields`).  Returns ((tid, lo, hi), its text, seconds), or
    None where the plan has fewer boundaries."""
    from htslib_tpu_torch.pileup import DEFAULT_SKIP, plan_tiles
    from htslib_tpu_torch.sam.record import BamRecord
    t0 = time.time()
    head, stream, _ = _zlib_stream(path)
    rs = stream_fields(stream)
    tiles, _ = plan_tiles(rs, nthreads, DEFAULT_SKIP)
    if k + 1 >= len(tiles):
        return None
    tid, at = tiles[k + 1][0][0]
    lo, hi = max(at - half, 0), at + half
    mv = memoryview(stream)
    keep = np.flatnonzero(((rs["flag"] & DEFAULT_SKIP) == 0)
                          & (rs["tid"] == tid) & (rs["end"] > lo)
                          & (rs["pos"] < hi))
    recs = [BamRecord.from_bam_buffer(mv, int(rs["offs"][i]) + 4,
                                      int(rs["sizes"][i])) for i in keep]
    from htslib_tpu_torch.sam.bam import BamReader
    with BamReader(path) as r:
        names = list(r.header.ref_names)
    return ((tid, lo, hi), _engine_lines(names, recs, (tid, lo), (tid, hi)),
            time.time() - t0)


def _leg16_read1_text(path: str):
    """16b's host truth: the port's engine over records from
    BamReader.read1 (zlib on the host), without the skipped flags."""
    from htslib_tpu_torch.pileup import DEFAULT_SKIP
    from htslib_tpu_torch.sam.bam import BamReader
    t0 = time.time()
    with BamReader(path) as r:
        recs = [b for b in iter(r.read1, None) if not b.flag & DEFAULT_SKIP]
        names = list(r.header.ref_names)
    return _engine_lines(names, recs), time.time() - t0


_BASE_MARKS = re.compile(rb"\^.|\$|[+-][0-9]+\([^)]*\)", re.S)
_NT16_CODE = np.full(256, -1, np.int64)
for _i, _c in enumerate(b"=ACMGRSVTWYHKDBN"):
    _NT16_CODE[_c] = _NT16_CODE[_c + 32 if _c >= 65 else _c] = _i


def pileup_text_counts(text: bytes):
    """Each column of pileup text: (reference name, 0-based position,
    depth from the third field, base counts by nt16 code from the base
    string with the markers ^x, $, +n(...), -n() and the *, <, > of
    deletions and skips left out).  Returns (names, positions, depths,
    counts int64 [columns, 16])."""
    names, poss, depths, stripped = [], [], [], []
    for line in text.split(b"\n"):
        if not line:
            continue
        f = line.split(b"\t")
        names.append(f[0].decode())
        poss.append(int(f[1]) - 1)
        depths.append(int(f[2]))
        stripped.append(_BASE_MARKS.sub(b"", f[3]))
    lens = np.array([len(s) for s in stripped], np.int64)
    codes = _NT16_CODE[np.frombuffer(b"".join(stripped), np.uint8)]
    col = np.repeat(np.arange(len(stripped)), lens)
    keep = codes >= 0
    counts = np.zeros((len(stripped), 16), np.int64)
    np.add.at(counts, (col[keep], codes[keep]), 1)
    return names, np.array(poss, np.int64), np.array(depths, np.int64), counts


def leg16(device, tmp: str, contigs=LEG16_CONTIGS, level: int = BGZF_LEVEL,
          small: int = LEG16_SMALL, half: int = LEG16_WINDOW // 2):
    """Leg 16, pileup (`samtools mpileup`) on the card: the files of
    write_leg16_files, the host truths in a pool of processes while the
    card works.  16a: mpileup_text_parallel on the whole BAM (X4, X5, B1;
    the tiles in the port's own pool): the inflated stream equals zlib's,
    member by member; X5's offsets and sizes the host walk's; B1's bases
    the host decode's; the tile plan the plan from host-decoded fields;
    the text's lines in a window `half` either side of every tile
    boundary the serial engine's over the reads overlapping that window;
    and device_pileup_counts on the card, for each whole reference, the
    depth of every column of the text (0 where it has none) and its base
    counts.  16b: mpileup_text on the first `small` records as a BAM of
    their own equals mpileup_text_parallel on it at LEG16_SMALL_THREADS
    and the engine fed by BamReader.read1.  16c: the same records as SAM
    text through mpileup_text (sam_text_to_bam, X5, B1) equal 16b's.
    Returns its notes."""
    from htslib_tpu_torch import pileup
    from htslib_tpu_torch.ops.pileup_kernel import device_pileup_counts
    from htslib_tpu_torch.sam.batch import _text_chunks as text_chunks
    from htslib_tpu_torch.sam.record import BamRecord
    t_leg = time.time()
    t0 = time.time()
    paths = write_leg16_files(tmp, contigs, level, small)
    notes = {"inputs_s": time.time() - t0, "records": paths["records"],
             "bam_bytes": os.path.getsize(paths["bam"])}
    nthreads = os.cpu_count() or 2
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=min(8, nthreads),
                             mp_context=ctx) as pool:
        truth = pool.submit(_leg16_host_truth, paths["bam"], nthreads)
        windows = [pool.submit(_leg16_window, paths["bam"], nthreads, k,
                               half) for k in range(nthreads - 1)]
        read1 = pool.submit(_leg16_read1_text, paths["small_bam"])

        # 16a: the whole BAM, tiles in the port's pool
        timing, stages = {}, {}
        t0 = time.time()
        header, text = pileup.mpileup_text_parallel(
            paths["bam"], device=device, timing=timing, stages=stages)
        wall = time.time() - t0
        names = list(header.ref_names)
        parse = [pool.submit(pileup_text_counts, c)
                 for c in text_chunks(text, len(text) // 8 + 1)]
        a = {"wall_s": wall, "timing": timing,
             "entries_per_s": timing["entries"] / wall,
             "text_bytes": len(text)}

        # the card's base and depth counts of each whole reference
        t0 = time.time()
        mv = memoryview(stages["payload"])
        keep = np.flatnonzero((stages["flag"] & pileup.DEFAULT_SKIP) == 0)
        recs = [BamRecord.from_bam_buffer(mv, int(stages["offs"][i]) + 4,
                                          int(stages["sizes"][i]))
                for i in keep]
        by_ref = {}
        for tid, (_, ln) in enumerate(contigs):
            by_ref[tid] = device_pileup_counts(
                [b for b in recs if b.tid == tid], 0, ln, device=device)
        a["device_counts_s"] = time.time() - t0

        # 16b and 16c on the card
        b_notes = {}
        for tag, run in (
                ("serial", lambda t: pileup.mpileup_text(
                    paths["small_bam"], device=device, timing=t)),
                ("parallel", lambda t: pileup.mpileup_text_parallel(
                    paths["small_bam"], LEG16_SMALL_THREADS, device=device,
                    timing=t)),
                ("sam", lambda t: pileup.mpileup_text(
                    paths["small_sam"], device=device, timing=t))):
            t, t0 = {}, time.time()
            b_notes[tag] = (run(t)[1], time.time() - t0, t)
        small_text = b_notes["serial"][0]
        require(b_notes["parallel"][0] == small_text,
                "16b: mpileup_text_parallel at 3 != mpileup_text")
        require(b_notes["sam"][0] == small_text,
                "16c: the SAM text's pileup != 16b's")

        # the truths of the pool
        t0 = time.time()
        tr, truth_s = truth.result()
        ok = stages["payload"] == tr["stream"]
        if not ok:
            us = np.cumsum([0] + tr["usizes"]) - tr["head"]
            got = np.frombuffer(stages["payload"], np.uint8)
            want = np.frombuffer(tr["stream"], np.uint8)
            n = min(len(got), len(want))
            first = int(np.flatnonzero(got[:n] != want[:n])[0]) if (
                got[:n] != want[:n]).any() else n
            require(False, "16a: the inflated stream != zlib's from member "
                    f"{int(np.searchsorted(us, first, side='right')) - 1}")
        require(np.array_equal(stages["offs"], tr["offs"])
                and np.array_equal(stages["sizes"], tr["sizes"]),
                "16a: X5's offsets and sizes != the host walk's")
        require(hashlib.sha256(stages["bases"]).hexdigest()
                == tr["bases_sha"], "16a: B1's bases != the host decode")
        require(stages["tiles"] == tr["tiles"],
                "16a: the tile plan != the plan from host fields")
        lines = text.split(b"\n")[:-1]
        keys = [(names.index(ln[:ln.index(b"\t")].decode()),
                 int(ln.split(b"\t", 2)[1]) - 1) for ln in lines]
        checked = []
        for fut in windows:
            got = fut.result()
            if got is None:
                continue
            (tid, lo, hi), want, secs = got
            i0 = bisect.bisect_left(keys, (tid, lo))
            i1 = bisect.bisect_left(keys, (tid, hi))
            mine = b"".join(ln + b"\n" for ln in lines[i0:i1])
            require(mine == want, f"16a: window {names[tid]}:{lo}-{hi} != "
                    "the serial engine's")
            checked.append((names[tid], lo, hi, i1 - i0, secs))
        require(len(checked) == len(stages["tiles"]) - 1,
                "16a: a tile boundary without its window")
        cols = [f.result() for f in parse]
        for tid, (name, ln) in enumerate(contigs):
            depth = np.zeros(ln, np.int64)
            counts = np.zeros((ln, 16), np.int64)
            for nms, poss, deps, cnt in cols:
                m = np.array([x == name for x in nms], bool)
                depth[poss[m]] = deps[m]
                counts[poss[m]] = cnt[m]
            d_dev, c_dev = by_ref[tid]
            require(np.array_equal(d_dev, depth),
                    f"16a: device_pileup_counts depth of {name}")
            require(np.array_equal(c_dev, counts),
                    f"16a: device_pileup_counts base counts of {name}")
        r1_text, r1_s = read1.result()
        require(r1_text == small_text,
                "16b: mpileup_text != the engine fed by BamReader.read1")
        notes["check"] = {
            "inflated_eq_zlib": True, "x5_eq_host_walk": True,
            "b1_eq_host_decode": True, "plan_eq_host_fields": True,
            "windows": checked, "device_counts_eq_text": True,
            "16b_eq": True, "16c_eq": True,
            "truth_s": truth_s, "read1_s": r1_s,
            "truth_wait_s": time.time() - t0}
    pileup.shutdown_pool()
    a["columns"] = timing["columns"]
    a["entries"] = timing["entries"]
    notes["16a"] = a
    notes["16b"] = {k: {"wall_s": v[1], "timing": v[2]}
                    for k, v in b_notes.items()}
    notes["stages"] = stages
    with open(paths["bam"], "rb") as fp:
        notes["bam_file"] = fp.read()
    notes["wall_s"] = time.time() - t_leg
    return notes



class _Stdout:
    """A stand-in for sys.stdout whose `buffer` keeps what a tool
    writes."""

    def __init__(self):
        self.buffer = io.BytesIO()

    def write(self, s):
        self.buffer.write(s.encode())
        return len(s)

    def flush(self):
        pass


def _cli(main, argv, **kw):
    """(exit code, standard output) of one run of a port tool's main."""
    saved = sys.stdout
    sys.stdout = out = _Stdout()
    try:
        rc = main(argv, **kw)
    finally:
        sys.stdout = saved
    return rc, out.buffer.getvalue()


def leg17_tsv(rng, n: int = LEG17_TSV_ROWS) -> str:
    """A BED-like TSV of `n` seeded intervals (1-based, inclusive) over
    leg 12's contigs' first 5 Mbp, with a header line."""
    rows = ["#chr\tbeg\tend\tname"]
    for i in range(n):
        beg = int(rng.integers(1, 5_000_000))
        rows.append(f"{LEG12_CONTIGS[i % 2][0]}\t{beg}\t"
                    f"{beg + int(rng.integers(0, 5_000))}\tf{i}")
    return "\n".join(rows) + "\n"


def leg17_regions():
    """Leg 14c's regions as tabix region strings (1-based)."""
    return [f"{LEG12_CONTIGS[t][0]}:{b0 + 1}-{e0}"
            for t, b0, e0 in leg14_vcf_regions(16)]


def leg17_files(tmp: str, l10_bam: str, l11, l12) -> dict:
    """The files of legs 10-16 that leg 17's htsfile reads: {path: a
    word its format's description must hold}."""
    at = lambda name: os.path.join(tmp, name)     # noqa: E731
    return {l10_bam: "BAM", l11["11a"]["path"]: "CRAM",
            l11["11b"]["path"]: "CRAM", l12["path"]: "BCF",
            at("leg12.vcf"): "VCF", at("leg14.bam.bai"): "BAI",
            at("leg14.bam.csi"): "CSI", at("leg14.bcf.csi"): "CSI",
            at("leg14.vcf.gz"): "VCF", at("leg14.vcf.gz.tbi"): "Tabix",
            at("leg14.fa.gz"): "FASTA", at("leg15.fq.gz"): "FASTQ",
            at("leg15_fq.bam"): "BAM", at("leg16.bam"): "BAM",
            at("leg16_small.sam"): "SAM"}


def leg17(device, tmp: str, l11, l14_lines, raws, encs, files) -> dict:
    """Leg 17, the last slice on the card, after leg 16, on the files of
    legs 10-16.  17a: kernel P1 (probe_pallas_gather.resolve_cmp) at
    the script's shapes equals its plain version.  17b: kernel P2
    (probe_rans_ablate.ablate) in every mode over the first BLOCKS of leg
    2's streams at SEG rounds equals its plain version; the full mode's
    symbols are the streams' raw bytes.  17c: 11a's references served by
    the port's AsyncRefCacheServer behind its RefCacheServer, whose
    upstream it is; with the FASTA moved away and REF_PATH the front's
    template, cram_file_to_sam on the card (B7, X1, X5, B1) gives 11a's
    text, the upstream is asked once for each M5 and the cache files'
    MD5s are their names.  17d: cram_file_to_bam_stream of 11a on the
    card, formatted by bam_payload_to_sam_device, gives 11a's text; the
    stream (notes' "blob_17d") is held to the host decode's by
    leg11_check's truths (_host_cram_truth with `blob`).  17e, the CLI:
    bgzip -i of leg 12's VCF text, -d (X4) gives it back, -t passes, -b/-s at
    LEG17_OFFSETS seeded offsets give its slices; tabix -p vcf, then leg
    14c's regions give leg 14c's lines; htsfile over `files` ({path:
    the word its description must hold}); annot-tsv -a cnt over two
    LEG17_TSV_ROWS-row TSVs equals RegIdx's overlap counts.  Returns its
    notes."""
    import hashlib

    import torch

    from htslib_tpu_torch import probe_pallas_gather as pg
    from htslib_tpu_torch import probe_rans_ablate as pa
    from htslib_tpu_torch.cli import annot_tsv, bgzip, htsfile, tabix
    from htslib_tpu_torch.cram.batch import (cram_file_to_bam_stream,
                                             cram_file_to_sam)
    from htslib_tpu_torch.faidx import Faidx
    from htslib_tpu_torch.ops.bam2sam import bam_payload_to_sam_device
    from htslib_tpu_torch.ops.rans_nx16 import frame_streams
    from htslib_tpu_torch.refcache import AsyncRefCacheServer, RefCacheServer
    from htslib_tpu_torch.regidx import RegIdx

    t_leg = time.time()
    notes = {}
    d = os.path.join(tmp, "leg17")
    os.makedirs(d)
    path, fasta = l11["11a"]["path"], l11["11a"]["ref"]
    # 17a: P1 at the script's shapes
    cum, freqs, _packed, x0 = pg.make_inputs()
    args = [torch.from_numpy(a).to(device) for a in (cum, freqs, x0)]
    got = pg.resolve_cmp(*args, device=device).cpu()
    require(torch.equal(got, pg.resolve_cmp_plain(*args).cpu()),
            "17a: P1 != its plain version")
    # warm, from CUDA events, through the wrapper (its table check waits
    # for the card)
    ms = cuda_ms(lambda: pg.resolve_cmp(*args, device=device), 5)
    notes["17a"] = {"call_ms": ms, "lookups_per_s": pg.G * pg.NSTATES
                    * pg.ROUNDS / (ms * 1e-3)}

    # 17b: P2, every mode
    t0 = time.time()
    b = frame_streams(encs[:pa.BLOCKS], device)
    want = pa.raw_symbols(raws[:pa.BLOCKS])
    ns = {}
    for mode in pa.MODES:
        got = pa.ablate(b, mode)
        plain = pa.ablate_plain(b, mode)
        # warm, from CUDA events, through the wrapper
        ns[mode] = cuda_ms(lambda: pa.ablate(b, mode), 3) / pa.SEG * 1e6
        for g, w, what in zip(got, plain, ("symbols", "states", "cursors")):
            require(torch.equal(g, w), f"17b: P2 {mode} != its plain "
                    f"version ({what})")
        if mode == "full":
            require(np.array_equal(got[0].cpu().numpy(), want),
                    "17b: P2's full mode != the streams' bytes")
    notes["17b"] = {"wall_s": time.time() - t0,
                    "ns_a_round_with_call": ns}

    # 17c: 11a through the reference cache, its FASTA moved away
    m5s = {}
    fai = Faidx.load(fasta)
    for ln in cram_header(path).lines:
        if ln.type == "SQ":
            m5s[ln.get("M5")] = fai.fetch_seq(ln.get("SN")).encode(
                ).upper()
    fai.close()
    up_log = os.path.join(d, "upstream.log")
    up = AsyncRefCacheServer(os.path.join(d, "upstream"),
                             upstream=None, log_path=up_log)
    up.start()
    front = RefCacheServer(os.path.join(d, "front"),
                           upstream=up.url_template)
    front.start()
    moved = fasta + ".moved"
    saved = {k: os.environ.get(k) for k in ("REF_CACHE", "REF_PATH")}
    try:
        for seq in m5s.values():
            up.put(seq)
        os.rename(fasta, moved)
        for k in saved:
            os.environ.pop(k, None)
        os.environ["REF_PATH"] = front.url_template
        t0 = time.time()
        _, sam = cram_file_to_sam(path, device=device)
        c = {"wall_s": time.time() - t0,
             "upstream_fetches": front.upstream_fetches}
    finally:
        if os.path.exists(moved):
            os.rename(moved, fasta)
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
        front.stop()
        up.stop()
        up._thread.join(timeout=30)
    require(sam.tobytes() == l11["11a"]["sam"],
            "17c: 11a through the reference cache != 11a's text")
    with open(up_log) as fp:
        asked = sorted(ln.split()[2].strip("/") for ln in fp)
    require(asked == sorted(m5s) and c["upstream_fetches"] == len(m5s),
            f"17c: the upstream was asked for {asked}")
    cached = {}
    for name in os.listdir(front.cache_dir):
        with open(os.path.join(front.cache_dir, name), "rb") as fp:
            cached[name] = hashlib.md5(fp.read()).hexdigest()
    require(cached == {m: m for m in m5s}, f"17c: cache files {cached}")
    notes["17c"] = c

    # 17d: 11a as a BAM record stream on the card
    t0 = time.time()
    hdr, blob = cram_file_to_bam_stream(path, ref=fasta, device=device)
    e = {"stream_s": time.time() - t0, "stream_bytes": len(blob)}
    t0 = time.time()
    text = bam_payload_to_sam_device(blob, hdr, device=device)
    e["format_s"] = time.time() - t0
    require(text == l11["11a"]["sam"], "17d: the stream, formatted, != "
            "11a's text")
    notes["17d"] = e
    # held to the host decode's blob with leg 11's truths (leg11_check)
    notes["blob_17d"] = blob

    # 17e: the command-line tools
    cli = {}
    with open(os.path.join(tmp, "leg12.vcf"), "rb") as fp:
        vcf_text = fp.read()
    vcf = os.path.join(d, "leg17.vcf")
    with open(vcf, "wb") as fp:
        fp.write(vcf_text)
    gz = vcf + ".gz"
    t0 = time.time()
    require(_cli(bgzip.main, ["-i", "-k", vcf], device=device)[0] == 0,
            "17e: bgzip -i")
    cli["bgzip_i_s"] = time.time() - t0
    t0 = time.time()
    require(_cli(bgzip.main, ["-d", "-f", "-k", gz], device=device)[0] == 0,
            "17e: bgzip -d")
    cli["bgzip_d_s"] = time.time() - t0
    with open(vcf, "rb") as fp:
        require(fp.read() == vcf_text, "17e: bgzip -d != the text")
    t0 = time.time()
    require(_cli(bgzip.main, ["-t", gz], device=device)[0] == 0,
            "17e: bgzip -t")
    cli["bgzip_t_s"] = time.time() - t0
    rng = np.random.default_rng(17)
    t0 = time.time()
    for _ in range(LEG17_OFFSETS):
        off = int(rng.integers(0, len(vcf_text)))
        size = int(rng.integers(1, 200_000))
        rc, out = _cli(bgzip.main, ["-b", str(off), "-s", str(size), gz],
                       device=device)
        require(rc == 0 and out == vcf_text[off:off + size],
                f"17e: bgzip -b {off} -s {size}")
    cli["bgzip_b_s"] = time.time() - t0
    t0 = time.time()
    require(_cli(tabix.main, ["-p", "vcf", gz])[0] == 0, "17e: tabix -p")
    cli["tabix_p_s"] = time.time() - t0
    t0 = time.time()
    rc, out = _cli(tabix.main, [gz] + leg17_regions())
    cli["tabix_regions_s"] = time.time() - t0
    require(rc == 0 and out.decode() == "".join(
        ln + "\n" for lines in l14_lines for ln in lines),
        "17e: tabix's regions != leg 14c's lines")
    cli["tabix_lines"] = out.count(b"\n")
    t0 = time.time()
    rc, out = _cli(htsfile.main, list(files))
    cli["htsfile_s"] = time.time() - t0
    seen = dict(ln.split(":\t", 1) for ln in out.decode().splitlines())
    require(rc == 0 and all(word in seen.get(p, "")
                            for p, word in files.items()),
            f"17e: htsfile said {seen}")
    cli["htsfile"] = {os.path.basename(p): v for p, v in seen.items()}
    tsv_rng = np.random.default_rng(171)
    src, tgt = os.path.join(d, "src.tsv"), os.path.join(d, "tgt.tsv")
    for p in (src, tgt):
        with open(p, "w") as fp:
            fp.write(leg17_tsv(tsv_rng))
    t0 = time.time()
    rc, out = _cli(annot_tsv.main, ["-s", src, "-t", tgt, "-a", "cnt"])
    cli["annot_tsv_s"] = time.time() - t0
    idx = RegIdx()
    with open(src) as fp:
        for ln in fp.read().splitlines()[1:]:
            c0, b0, e0, name = ln.split("\t")
            idx.push(c0, int(b0) - 1, int(e0) - 1, name)
    want = ["#[1]chr\t[2]beg\t[3]end\t[4]name\t[5]cnt"]
    with open(tgt) as fp:
        for ln in fp.read().splitlines()[1:]:
            c0, b0, e0, _ = ln.split("\t")
            hits = idx.overlap(c0, int(b0) - 1, int(e0) - 1)
            want.append(f"{ln}\t{len(list(hits))}")
    require(rc == 0 and out.decode().splitlines() == want,
            "17e: annot-tsv's counts != RegIdx's overlaps")
    cli["annot_tsv_hits"] = sum(int(ln.rsplit("\t", 1)[1]) > 0
                                for ln in want[1:])
    notes["17e"] = cli
    notes["wall_s"] = time.time() - t_leg
    return notes


def leg12(device, tmp: str):
    """Leg 12's work in this process (12a): leg12_vcf written to `tmp`
    and encoded by vcf_file_to_bcf (host), then bcf_file_to_vcf on the
    card (the body's members through X4, records framed and formatted on
    the host), then plan_bcf_shards(N_RANKS) on the card for leg 10b's
    ranks (12b).  Returns its notes (times, the text, the plan, the BCF's
    path)."""
    from htslib_tpu_torch.parallel.distributed import plan_bcf_shards
    from htslib_tpu_torch.vcf.io import bcf_file_to_vcf, vcf_file_to_bcf
    t0 = time.time()
    vcf, bcf = os.path.join(tmp, "leg12.vcf"), os.path.join(tmp,
                                                            "leg12.bcf")
    with open(vcf, "wb") as fp:
        fp.write(leg12_vcf(N_VCF))
    notes = {"inputs_s": time.time() - t0, "vcf_bytes": os.path.getsize(vcf)}
    t0 = time.time()
    n = vcf_file_to_bcf(vcf, bcf)
    notes.update(encode_s=time.time() - t0, bcf_bytes=os.path.getsize(bcf),
                 path=bcf)
    require(n == N_VCF, f"leg 12 records {n}")
    timing = {}
    t0 = time.time()
    header, text = bcf_file_to_vcf(bcf, device=device, timing=timing)
    notes["decode_s"] = time.time() - t0
    notes.update(parts=timing, text=text, text_bytes=len(text),
                 header=header.text(with_idx=True),
                 vcf_MBps=len(text) / notes["decode_s"] / 1e6)
    t0 = time.time()
    plan = plan_bcf_shards(bcf, N_RANKS, device=device)
    notes["plan_s"] = time.time() - t0
    require(len(plan.shards) == N_RANKS, "leg 12 plan's shards")
    require(sum(sh.rec_hi - sh.rec_lo for sh in plan.shards) == N_VCF,
            "leg 12 plan's records")
    notes.update(plan=plan, members=len(plan.coffsets))
    # the body's members and their bytes, for phase 6's X4 case
    from htslib_tpu_torch.bgzf import member_payload
    from htslib_tpu_torch.vcf.io import bcf_members
    raw = np.fromfile(bcf, np.uint8)
    co, cs = bcf_members(raw)[:2]
    payloads = [member_payload(raw, int(o), int(c)) for o, c in zip(co, cs)]
    notes["x4_members"] = (payloads, [zlib.decompress(p, -15)
                                      for p in payloads])
    return notes


def _leg12_format(path: str, lo: int, hi: int) -> bytes:
    """The host path over records [lo, hi) of a BCF file: the port's
    BcfReader (zlib on the host), its frames formatted by
    BcfRecord.from_bcf(...).to_vcf."""
    from htslib_tpu_torch.vcf.io import BcfReader, format_frames, split_frames
    with BcfReader(path) as r:
        shared, indiv = split_frames(r.fp.read_all().tobytes())
        return format_frames(shared[lo:hi], indiv[lo:hi], r.header)


def _leg12_encode(header_text: str, body: bytes) -> bytes:
    """VCF body text re-encoded by the port's from_vcf and to_bcf."""
    from htslib_tpu_torch.vcf.header import BcfHeader
    from htslib_tpu_torch.vcf.io import vcf_body_to_bcf_frames
    return vcf_body_to_bcf_frames(body, BcfHeader(header_text))


def leg12_check(notes, rank_outs, pool, parts: int = 8):
    """Leg 12's truths, after leg 10b's ranks decoded 12b's shards: 12a's
    text equals the host path's (zlib, BcfRecord.from_bcf(...).to_vcf;
    `parts` tasks of `pool`, a range of records each); the header and the
    records of 12a's text re-encoded by the port's to_bcf (`parts` tasks,
    a range of lines each) give the file's inflated header and body byte
    for byte; the ranks' shards in order equal 12a's text.  Returns the
    notes of the check."""
    import struct as _st

    from htslib_tpu_torch.bgzf import BgzfReader
    from htslib_tpu_torch.vcf.io import BCF_MAGIC
    t0 = time.time()
    path, text = notes["path"], notes["text"]
    with BgzfReader(path) as r:
        stream = r.read_all().tobytes()
    hdr = notes["header"].encode() + b"\0"
    require(stream[:len(BCF_MAGIC) + 4 + len(hdr)] == BCF_MAGIC
            + _st.pack("<I", len(hdr)) + hdr, "leg 12 header re-encoded "
            "!= the file's")
    body = stream[len(BCF_MAGIC) + 4 + len(hdr):]
    lines = text.split(b"\n")[:-1]
    cuts = [len(lines) * k // parts for k in range(parts + 1)]
    host = [pool.submit(_leg12_format, path, a, b)
            for a, b in zip(cuts, cuts[1:])]
    frames = [pool.submit(_leg12_encode, notes["header"],
                          b"\n".join(lines[a:b]) + b"\n")
              for a, b in zip(cuts, cuts[1:])]
    require(b"".join(f.result() for f in host) == text,
            "leg 12a VCF != the host path's")
    require(b"".join(f.result() for f in frames) == body,
            "leg 12a records re-encoded by to_bcf != the file's body")
    shards = b"".join(o.pop("vcf") for o in rank_outs)
    require(shards == text, "leg 12b sharded BCF decode != single-process "
            "VCF")
    decode = max(o["bcf_decode_s"] for o in rank_outs)
    return {"check_s": time.time() - t0, "shards_decode_s": decode,
            "shards_vcf_MBps": len(shards) / decode / 1e6}


def bgzf_blocks(blob: bytes):
    """(CRC, ISIZE, payload) of each block of a stored-block BGZF file."""
    off = 0
    while off < len(blob):
        bsize = struct.unpack_from("<H", blob, off + 16)[0] + 1
        crc, isize = struct.unpack_from("<II", blob, off + bsize - 8)
        yield crc, isize, blob[off + 23:off + bsize - 8]
        off += bsize


def leg7(device, bgzf, raws):
    """Leg 7, the BGZF layer: bgzf = (payloads, raw pieces) of leg 1's
    BAM record stream, inflated on the card; leg 2's raw qualities
    written as stored and as uniform-Huffman BGZF.  Returns its notes."""
    from htslib_tpu_torch.ops.bgzf_device import (bgzf_stored_device,
                                                  crc_device_rate,
                                                  deflate_uniform_device)
    from htslib_tpu_torch.ops.inflate import inflate_batch
    payloads, pieces = bgzf
    notes = {"members": len(payloads), "in_bytes": sum(map(len, payloads)),
             "out_bytes": sum(map(len, pieces))}
    parts = {}
    t0 = time.time()
    out = inflate_batch(payloads, [len(p) for p in pieces], device=device,
                        timing=parts)
    notes["inflate_batch_s"] = time.time() - t0
    notes["inflate_parts"] = parts
    require(out == pieces, "leg 7 inflated members")
    notes["inflate_MBps"] = notes["out_bytes"] / notes["inflate_batch_s"] / 1e6
    notes["inflated"] = b"".join(out)

    qual = b"".join(raws)
    timing = {}
    t0 = time.time()
    blob = bgzf_stored_device(qual, device=device, timing=timing)
    notes["stored_s"] = time.time() - t0
    notes["stored_timing"] = timing
    t0 = time.time()
    blocks = list(bgzf_blocks(blob))
    require(len(blocks) == len(qual) // 0xff00 + 2,
            f"leg 7 stored block count {len(blocks)}")
    for i, (crc, isize, pl) in enumerate(blocks):
        require(crc == zlib.crc32(pl) and isize == len(pl),
                f"leg 7 stored block {i}: CRC or ISIZE")
    # gzip.decompress copies the data left after each member, so this
    # check of a 644-member file takes seconds: timed apart
    require(gzip.decompress(blob) == qual, "leg 7 stored BGZF round trip")
    notes["stored_check_s"] = time.time() - t0
    notes["stored_blocks"] = len(blocks) - 1
    t0 = time.time()
    notes["crc_rate"] = crc_device_rate(n_blocks=128, reps=3, device=device)
    notes["crc_rate_call_s"] = time.time() - t0
    require(notes["crc_rate"]["exact"], "leg 7 crc_device_rate not exact")
    stats = {}
    t0 = time.time()
    dblob = deflate_uniform_device(qual[:DEFLATE_BYTES], device=device,
                                   stats=stats)
    notes["deflate_s"] = time.time() - t0
    t0 = time.time()
    require(gzip.decompress(dblob) == qual[:DEFLATE_BYTES],
            "leg 7 deflate_uniform_device round trip")
    notes["deflate_check_s"] = time.time() - t0
    notes["deflate_stats"] = stats
    notes["deflate_ratio"] = len(dblob) / DEFLATE_BYTES
    return notes


O1_WIRES = ("4x8_o1", "nx16_4way_o1", "nx16_o1")   # leg 6's order-1 wires


def o1_rows_of(wire: str, enc: bytes) -> int:
    """(context, symbol) rows of an encoded order-1 stream's table."""
    from htslib_tpu_torch.ops.rans4x8 import _parse_4x8_o1
    from htslib_tpu_torch.ops.rans_nx16_o1 import (_parse_nx16_header,
                                                   o1_row_count)
    if wire == "4x8_o1":
        return o1_row_count(_parse_4x8_o1(enc)[1])
    return o1_row_count(_parse_nx16_header(
        enc, 32 if wire == "nx16_o1" else 4)[1])


def spill_copies(device, leg3) -> dict:
    """{order-1 wire: copies of its spill stream one past LARGE_WAVES waves
    of its large variant on `device`} (1 where no wave bounds a group: the
    CPU)."""
    from htslib_tpu_torch.ops import rans4x8 as t8
    from htslib_tpu_torch.ops import rans_nx16_o1 as to1
    out = {}
    for w in O1_WIRES:
        enc = leg3[w + "_spill"][1]
        if w == "nx16_o1":
            F = to1._parse_nx16_header(enc)[1]
            per = to1.large_per_wave(to1.o1_row_count(F),
                                     to1.o1_alphabet(F), device)
            waves = to1.LARGE_WAVES
        else:
            per = t8.large_per_wave(o1_rows_of(w, enc), w != "4x8_o1",
                                    device)
            waves = t8.LARGE_WAVES
        out[w] = 1 if per is None else waves * per + 1
    return out


def _interleave(lists):
    """The items of several lists taken in turns: a0, b0, c0, a1, ..."""
    out = []
    for i in range(max(len(x) for x in lists)):
        out += [x[i] for x in lists if i < len(x)]
    return out


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of fn over `iters` calls, from CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def bound_ms(n_bytes: float, n_ops: float):
    """The least time for the work: bytes over the memory rate or
    operations over the scalar rate, whichever is larger."""
    tb = n_bytes / HBM_BYTES_S * 1e3
    to = n_ops / SCALAR_OPS_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def kernels_vs_plain(seq4_d, encs, launches):
    """Phase 6: each kernel against its plain version on the same card
    tensors, with times.  Returns the rows of the kernels line."""
    import torch

    from htslib_tpu_torch.ops.device_stats import QBINS
    from htslib_tpu_torch.ops import rans_nx16
    from htslib_tpu_torch.ops.rans_nx16 import (frame_streams, rans_o0_cuda,
                                                rans_o0_plain)
    from htslib_tpu_torch.ops.seqfmt import (nibble_to_base_cuda,
                                             nibble_to_base_plain)
    rows = []
    got = nibble_to_base_cuda(seq4_d)
    ref = nibble_to_base_plain(seq4_d)
    require(torch.equal(got, ref), "B1 kernel != plain")
    # the library yardstick: one gather through a 256-entry table of
    # base pairs (u16), indexed by the packed byte
    pairs = nt16_numpy(np.arange(256, dtype=np.uint8)[:, None])
    lut2 = torch.from_numpy(pairs.view(np.int16)[:, 0].copy()).to(
        seq4_d.device)
    lib = lut2[seq4_d.long()].view(torch.uint8)
    require(torch.equal(lib, ref), "B1 library yardstick != plain")
    n = seq4_d.numel()
    b_ms, b_by = bound_ms(3 * n, 6 * n)
    rows.append({
        "name": "nibble_to_base", "route": "cuda",
        "source": "htslib_tpu_torch/csrc/nibble.cu",
        "replaces": "htslib_tpu/ops/seqfmt.py:54",
        "launches": launches["nibble_to_base"],
        "max_abs_err": int((got.int() - ref.int()).abs().max()),
        "ms": cuda_ms(lambda: nibble_to_base_cuda(seq4_d), 50),
        "plain_ms": cuda_ms(lambda: nibble_to_base_plain(seq4_d), 10),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(lambda: lut2[seq4_d.long()], 10),
        "shape": list(seq4_d.shape), "match": True})

    for key, blocks, qb, line in (
            ("rans_nx16_o0_decode", encs[:N_DECODE], None, 234),
            ("rans_nx16_o0_hist", encs, QBINS, 323)):
        b = frame_streams(blocks, seq4_d.device)
        offs = torch.zeros(b.n_streams, dtype=torch.int32,
                           device=seq4_d.device)
        got = rans_o0_cuda(b, offs=offs, qbins=qb)
        torch.cuda.synchronize()
        t0 = time.time()
        ref = rans_o0_plain(b, offs=offs, qbins=qb)
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3
        for g, r, what in zip(got, ref, ("output", "states", "cursors")):
            require(torch.equal(g, r), f"{key} kernel != plain ({what})")
        n_sym = b.total_out
        n_out = n_sym if qb is None else 4 * qb * b.n_streams
        # per symbol: mask, table lookup, two table loads, shift,
        # multiply-add, subtract, compare, and the store or bin
        b_ms, b_by = bound_ms(sum(len(x) for x in blocks) + n_out,
                              10 * n_sym)
        rows.append({
            "name": key, "route": "cuda",
            "source": "htslib_tpu_torch/csrc/rans_nx16_o0.cu",
            "replaces": f"htslib_tpu/ops/rans_pallas.py:{line}",
            "launches": launches[key],
            "max_abs_err": int((got[0].long() - ref[0].long()).abs().max()),
            "ms": cuda_ms(lambda: rans_o0_cuda(b, offs=offs, qbins=qb), 5),
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "streams": b.n_streams, "symbols": n_sym,
            "chain_rounds": -(-int(b.ulen.max()) // 32),
            # a checkout older than the kernels' blocks_per_sm gives None
            "streams_per_sm": (rans_nx16.blocks_per_sm(qb) if hasattr(
                rans_nx16, "blocks_per_sm") else None), "match": True})
    return rows


# the order-1 kernels of csrc/rans4x8.cu with two table layouts
O1_LAYOUT_KEYS = ("rans4x8_o1_hist", "rans4x8_o1_decode",
                  "rans_nx16_4way_o1_decode")
O1_LAYOUTS = ("wide", "compact")


def leg3_kernels_vs_plain(device, leg3, launches):
    """Phase 6 for kernels B5-B8 and X1-X3: each kernel against its plain
    version on the same card tensors, at full size over the first
    PLAIN_ROUNDS rounds and over whole streams on the 64 KiB batch, with
    times.  Returns the rows of the kernels line."""
    import torch

    from htslib_tpu_torch.ops import rans4x8 as t8
    from htslib_tpu_torch.ops.device_stats import QBINS
    from htslib_tpu_torch.ops.rans4x8 import (frame_4x8, frame_nx16_4way,
                                              rans4x8_cuda, rans4x8_plain)
    from htslib_tpu_torch.ops.rans_nx16_o1 import (_parse_nx16_header,
                                                   frame_o1_streams,
                                                   rans_o1_cuda,
                                                   rans_o1_plain)

    def o1_batch(blocks):
        return frame_o1_streams([_parse_nx16_header(e) for e in blocks],
                                device)

    def chain_o1(n, nway):   # the last state's length (order 1)
        return n - (nway - 1) * (n // nway)

    # (launch key, wire, streams, qbins, framing, kernel, plain, source,
    #  TPU kernel, chain rounds of a stream of n symbols, ops per symbol:
    #  mask, lookup (order 1: bucket, row and one compare more), two
    #  field extracts, multiply-add, compare, refill select, and the store
    #  or bin)
    specs = [
        ("rans_nx16_o1_decode", "nx16_o1", N_DECODE, None, o1_batch,
         rans_o1_cuda, rans_o1_plain, "rans_nx16_o1.cu",
         "rans_o1_pallas.py:98", lambda n: chain_o1(n, 32), 12),
        ("rans_nx16_o1_hist", "nx16_o1", None, QBINS, o1_batch,
         rans_o1_cuda, rans_o1_plain, "rans_nx16_o1.cu",
         "rans_o1_pallas.py:170", lambda n: chain_o1(n, 32), 12),
        ("rans4x8_o0_decode", "4x8_o0", N_DECODE, None,
         lambda e: frame_4x8(e, False, device), rans4x8_cuda, rans4x8_plain,
         "rans4x8.cu", "rans4x8_pallas.py:49", lambda n: -(-n // 4), 10),
        ("rans4x8_o0_hist", "4x8_o0", None, QBINS,
         lambda e: frame_4x8(e, False, device), rans4x8_cuda, rans4x8_plain,
         "rans4x8.cu", "rans4x8_pallas.py:120", lambda n: -(-n // 4), 10),
        ("rans4x8_o1_hist", "4x8_o1", None, QBINS,
         lambda e: frame_4x8(e, True, device), rans4x8_cuda, rans4x8_plain,
         "rans4x8.cu", "rans4x8_pallas.py:120", lambda n: chain_o1(n, 4),
         12),
        # X1-X3 replace XLA loops of ops/rans.py, not Pallas kernels
        ("rans4x8_o1_decode", "4x8_o1", None, None,
         lambda e: frame_4x8(e, True, device), rans4x8_cuda, rans4x8_plain,
         "rans4x8.cu", "rans.py:96", lambda n: chain_o1(n, 4), 12),
        ("rans_nx16_4way_o0_decode", "nx16_4way_o0", N_DECODE, None,
         lambda e: frame_nx16_4way(e, False, device), rans4x8_cuda,
         rans4x8_plain, "rans4x8.cu", "rans.py:230", lambda n: -(-n // 4),
         10),
        ("rans_nx16_4way_o1_decode", "nx16_4way_o1", N_DECODE, None,
         lambda e: frame_nx16_4way(e, True, device), rans4x8_cuda,
         rans4x8_plain, "rans4x8.cu", "rans.py:230",
         lambda n: chain_o1(n, 4), 12),
    ]
    rows = []
    for (key, wire, n_streams, qb, frame, kern, plain, src, line, chain,
         ops) in specs:
        blocks = leg3[wire][1][:n_streams]
        b = frame(blocks)
        offs = torch.zeros(b.n_streams, dtype=torch.int32, device=device)
        # X1, X3 and B8 order 1: both order-1 tables, each held to the
        # plain version; the row's ms is the layout the batch takes
        lays = O1_LAYOUTS if key in O1_LAYOUT_KEYS else (None,)

        def run(bb, mr, oo, lay, kern=kern, qb=qb):
            if lay is None:
                return kern(bb, mr, oo, qb)
            return rans4x8_cuda(bb, mr, oo, qb, layout=lay)

        got = run(b, PLAIN_ROUNDS, offs, lays[0])
        torch.cuda.synchronize()
        t0 = time.time()
        ref = plain(b, PLAIN_ROUNDS, offs, qb)
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3
        err = int((got[0].long() - ref[0].long()).abs().max())
        small = frame(leg3[wire][3])
        soffs = torch.zeros(small.n_streams, dtype=torch.int32, device=device)
        sref = plain(small, -1, soffs, qb)
        for lay in lays:
            for g, r, what in zip(run(b, PLAIN_ROUNDS, offs, lay), ref,
                                  ("output", "states", "cursors",
                                   "contexts")):
                require(torch.equal(g, r),
                        f"{key} kernel ({lay}) != plain over {PLAIN_ROUNDS} "
                        f"rounds ({what})")
            for g, r, what in zip(run(small, -1, soffs, lay), sref,
                                  ("output", "states", "cursors",
                                   "contexts")):
                require(torch.equal(g, r), f"{key} kernel ({lay}) != plain "
                        f"on whole 64 KiB streams ({what})")
        n_sym = b.total_out
        n_out = n_sym if qb is None else 4 * qb * b.n_streams
        b_ms, b_by = bound_ms(sum(len(x) for x in blocks) + n_out,
                              ops * n_sym)
        rounds = max(chain(int(n)) for n in b.ulen.tolist())
        ms = {lay: cuda_ms(lambda lay=lay: run(b, -1, offs, lay), 3)
              for lay in lays}
        chosen = None
        if key in O1_LAYOUT_KEYS:
            chosen = "wide" if t8.wide_fits(b, qb is not None) else "compact"
        rows.append({
            "name": key, "route": "cuda",
            "source": f"htslib_tpu_torch/csrc/{src}",
            "replaces": f"htslib_tpu/ops/{line}",
            "launches": launches[key], "max_abs_err": err,
            "ms": ms[chosen],
            "plain_ms": plain_ms, "plain_rounds": PLAIN_ROUNDS,
            "ms_at_plain_rounds": cuda_ms(
                lambda: run(b, PLAIN_ROUNDS, offs, chosen), 3),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "streams": b.n_streams, "symbols": n_sym,
            "chain_rounds": rounds, "match": True})
        if key.startswith("rans_nx16_o1"):
            rows[-1].update(o1_table_notes(b, offs, qb))
        elif chosen is not None:
            hist = qb is not None
            slow = t8.max_slow(b.tables)
            rows[-1].update({
                "layout": chosen,
                "ms_by_layout": ms,
                "ns_per_round_by_layout": {k: v / rounds * 1e6
                                           for k, v in ms.items()},
                "streams_per_sm_by_layout": {
                    "wide": t8.wide_blocks_per_sm(hist, b.w16, slow),
                    "compact": t8.blocks_per_sm(hist, True, b.w16)},
                "smem_bytes_by_layout": {
                    "wide": t8.wide_smem_bytes(hist, slow),
                    "compact": t8.smem_bytes(hist, True)},
                "max_slow_buckets": slow,
                "streams_per_sm": (t8.wide_blocks_per_sm(hist, b.w16, slow)
                                   if chosen == "wide" else
                                   t8.blocks_per_sm(hist, True, b.w16)),
                "smem_bytes": (t8.wide_smem_bytes(hist, slow)
                               if chosen == "wide" else
                               t8.smem_bytes(hist, True))})
        else:
            rows[-1]["streams_per_sm"] = t8.blocks_per_sm(
                qb is not None, b.o1, b.w16)
            rows[-1]["smem_bytes"] = t8.smem_bytes(qb is not None, b.o1)
        if line.startswith("rans.py"):
            rows[-1]["note"] = ("XLA code of the JAX package (no Pallas "
                                "kernel) that the port hand-writes")
    # B5, B6 and B8 order 1 over a whole wide-alphabet stream, whose
    # lookups meet slow buckets (B5/B6: their maps; B8: the walk)
    wide = o1_batch([leg3["nx16_o1_wide"][1]])
    n_fall = fallback_buckets(wide.tables)
    require(n_fall > 0, "wide Nx16 order-1 stream: no slow bucket")
    woffs = torch.zeros(1, dtype=torch.int32, device=device)
    for row, qb in zip(rows[:2], (None, QBINS)):
        slow = torch.zeros(1, dtype=torch.int32, device=device)
        for g, r, what in zip(rans_o1_cuda(wide, -1, woffs, qb, slow),
                              rans_o1_plain(wide, -1, woffs, qb),
                              ("output", "states", "cursors", "contexts")):
            require(torch.equal(g, r), f"{row['name']} kernel != plain on "
                    f"the whole wide-alphabet stream ({what})")
        rounds = int(wide.ulen[0]) - 31 * (int(wide.ulen[0]) // 32)
        require(int(slow[0]) > 0, f"{row['name']}: no round of the wide "
                "stream met a slow bucket")
        row["wide_stream"] = {"bytes": int(wide.ulen[0]),
                              "fallback_buckets": n_fall,
                              "slow_share": int(slow[0]) / rounds,
                              "match": True}
    # B8 order 1, X1 and X3 over the same bytes on their wires
    by_name = {row["name"]: row for row in rows}
    for key, wire, frame, qb in (
            ("rans4x8_o1_hist", "4x8_o1_wide",
             lambda e: frame_4x8(e, True, device), QBINS),
            ("rans4x8_o1_decode", "4x8_o1_wide",
             lambda e: frame_4x8(e, True, device), None),
            ("rans_nx16_4way_o1_decode", "nx16_4way_o1_wide",
             lambda e: frame_nx16_4way(e, True, device), None)):
        wide = frame([leg3[wire][1]])
        n_fall = fallback_buckets(wide.tables)
        require(n_fall > 0, f"wide {wire} stream: no bucket reaches the "
                "lookup's loop")
        woffs = torch.zeros(1, dtype=torch.int32, device=device)
        wref = rans4x8_plain(wide, -1, woffs, qb)
        for lay in O1_LAYOUTS:
            for g, r, what in zip(rans4x8_cuda(wide, -1, woffs, qb,
                                               layout=lay), wref,
                                  ("output", "states", "cursors",
                                   "contexts")):
                require(torch.equal(g, r), f"{key} kernel ({lay}) != plain "
                        f"on the whole wide-alphabet stream ({what})")
        by_name[key]["wide_stream"] = {"bytes": int(wide.ulen[0]),
                                       "fallback_buckets": n_fall,
                                       "match": True}
    return rows


def dense_vs_plain(device, leg3, launches):
    """Phase 6 for the dense variants of X1, X3 and B5: each against its
    plain version (a gather from the same dense table) on leg 6's dense
    streams over their first PLAIN_ROUNDS rounds, with times.  Returns
    the rows of the kernels line."""
    import torch

    from htslib_tpu_torch.ops import rans4x8 as t8
    from htslib_tpu_torch.ops import rans_nx16_o1 as to1
    from htslib_tpu_torch.ops.rans4x8 import (frame_4x8, frame_nx16_4way,
                                              rans4x8_cuda, rans4x8_plain)
    from htslib_tpu_torch.ops.rans_nx16_o1 import (_parse_nx16_header,
                                                   frame_o1_streams,
                                                   rans_o1_cuda,
                                                   rans_o1_plain)

    def chain_o1(n, nway):
        return n - (nway - 1) * (n // nway)

    # (launch key, wire, framing, kernel, plain, source, XLA loop, states)
    specs = [
        ("rans4x8_o1_dense_decode", "4x8_o1_dense",
         lambda e: frame_4x8(e, True, device, True), rans4x8_cuda,
         rans4x8_plain, "rans4x8.cu", "rans.py:96", 4),
        ("rans_nx16_4way_o1_dense_decode", "nx16_4way_o1_dense",
         lambda e: frame_nx16_4way(e, True, device, True), rans4x8_cuda,
         rans4x8_plain, "rans4x8.cu", "rans.py:230", 4),
        ("rans_nx16_o1_dense_decode", "nx16_o1_dense",
         lambda e: frame_o1_streams([_parse_nx16_header(x) for x in e],
                                    device, True), rans_o1_cuda,
         rans_o1_plain, "rans_nx16_o1.cu", "rans.py:230", 32),
    ]
    rows = []
    for key, wire, frame, kern, plain, src, line, nway in specs:
        raws, blocks = leg3[wire]
        b = frame(blocks)
        require(b.dense is not None and b.tables is None,
                f"{key}: the batch carries no dense table")
        got = kern(b, PLAIN_ROUNDS)
        torch.cuda.synchronize()
        t0 = time.time()
        ref = plain(b, PLAIN_ROUNDS)
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3
        for g, r, what in zip(got, ref, ("output", "states", "cursors",
                                         "contexts")):
            require(torch.equal(g, r), f"{key} kernel != plain over "
                    f"{PLAIN_ROUNDS} rounds ({what})")
        full = kern(b)[0].cpu().numpy().tobytes()
        require(full == b"".join(raws), f"{key}: whole streams != raw")
        n_sym = b.total_out
        # the function's own work, whatever table implements it: the
        # streams (frequency headers included) in, the symbols out; per
        # symbol: mask, table load, three field extracts, multiply-add,
        # subtract, compare, refill select and the store
        b_ms, b_by = bound_ms(sum(len(x) for x in blocks) + n_sym,
                              10 * n_sym)
        row = {
            "name": key, "route": "cuda",
            "source": f"htslib_tpu_torch/csrc/{src}",
            "replaces": f"htslib_tpu/ops/{line}",
            "launches": launches[key],
            "max_abs_err": int((got[0].long() - ref[0].long()).abs().max()),
            "ms": cuda_ms(lambda: kern(b), 3), "plain_ms": plain_ms,
            "plain_rounds": PLAIN_ROUNDS,
            "ms_at_plain_rounds": cuda_ms(lambda: kern(b, PLAIN_ROUNDS), 3),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "streams": b.n_streams, "symbols": n_sym,
            "chain_rounds": max(chain_o1(int(n), nway)
                                for n in b.ulen.tolist()),
            "note": "dense-table variant for order-1 tables past A2_MAX "
                    "rows: XLA code of the JAX package, no Pallas kernel",
            "match": True}
        if nway == 4:
            row["smem_bytes"] = t8.smem_bytes(False, True, True)
            row["streams_per_sm"] = t8.blocks_per_sm(False, True, b.w16,
                                                     True)
        else:
            row["smem_bytes"] = to1.dense_smem_bytes()
        rows.append(row)
    return rows


def large_vs_plain(device, leg3, launches):
    """Phase 6 for the large-table variants of X1, X3 and B5 (order-1
    tables past A2_MAX rows in shared memory): each against its plain
    version (a gather from the JAX dense table of the same rows) on leg
    6's 2 x 256 KiB random streams and on its HiFi-style block over their
    first PLAIN_ROUNDS rounds (states, cursors, contexts, symbols) and
    whole against the raw bytes, and on a whole 64 KiB random stream (the
    spill stream) in every output; timed on both batches, with ns a round,
    shared memory a block and streams an SM of each (B5: the share of
    rounds in which a lane walked).  Returns the rows of the kernels
    line."""
    import torch

    from htslib_tpu_torch.ops import rans4x8 as t8
    from htslib_tpu_torch.ops import rans_nx16_o1 as to1

    def frame(wire, blocks):
        if wire == "nx16_o1":
            return to1.frame_o1_streams([to1._parse_nx16_header(e)
                                         for e in blocks], device,
                                        large=True)
        fr = t8.frame_4x8 if wire == "4x8_o1" else t8.frame_nx16_4way
        return fr(blocks, True, device, large=True)

    def held(key, kern, plain, b, rounds, what):
        got = kern(b, rounds)
        torch.cuda.synchronize()
        t0 = time.time()
        ref = plain(b, rounds)
        torch.cuda.synchronize()
        ms = (time.time() - t0) * 1e3
        for g, r, part in zip(got, ref, ("output", "states", "cursors",
                                         "contexts")):
            require(torch.equal(g, r), f"{key} kernel != plain on {what} "
                    f"over {rounds} rounds ({part})")
        return got, ms, int((got[0].long() - ref[0].long()).abs().max())

    rows = []
    for key, wire, src, line in (
            ("rans4x8_o1_large_decode", "4x8_o1", "rans4x8.cu", 96),
            ("rans_nx16_4way_o1_large_decode", "nx16_4way_o1", "rans4x8.cu",
             230),
            ("rans_nx16_o1_large_decode", "nx16_o1", "rans_nx16_o1.cu",
             230)):
        nway = 32 if wire == "nx16_o1" else 4
        slow = []   # B5: the last launch's walked rounds a stream
        if nway == 32:
            def kern(b, mr=-1):
                slow[:] = [torch.zeros(b.n_streams, dtype=torch.int32,
                                       device=device)]
                return to1.rans_o1_cuda(b, mr, slow_rounds=slow[0])
            plain = to1.rans_o1_plain
        else:
            kern, plain = t8.rans4x8_cuda, t8.rans4x8_plain
        row = {"name": key, "route": "cuda",
               "source": f"htslib_tpu_torch/csrc/{src}",
               "replaces": f"htslib_tpu/ops/rans.py:{line}",
               "launches": launches[key], "bound_by": None,
               "library_ms": None, "plain_rounds": PLAIN_ROUNDS,
               "note": "large-table variant for order-1 tables past A2_MAX "
                       "rows: XLA code of the JAX package, no Pallas kernel",
               "match": True}
        err = 0
        for tag, (raws, blocks) in (
                ("", leg3[wire + "_dense"]), ("_hifi", leg3[wire + "_hifi"])):
            b = frame(wire, blocks)
            require(b.large and b.dense is None,
                    f"{key}: the batch is not a large-table batch")
            _, plain_ms, e = held(key, kern, plain, b, PLAIN_ROUNDS,
                                  "leg 6's streams" if not tag else "HiFi")
            err = max(err, e)
            full = kern(b)
            require(full[0].cpu().numpy().tobytes() == b"".join(raws),
                    f"{key}{tag}: whole streams != raw")
            n_sym = b.total_out
            rows_max = int(b.tables.n_rows.max())
            # the bucket shift and shared memory the wrappers chose
            if nway == 32:
                shift, smem = to1.large_shift(b.tables, device, b.alphabet)
                per_sm = to1.large_blocks_per_sm(smem)
                rounds = sum(u - 31 * (u // 32) for u in b.ulen.tolist())
                row["slow_share" + tag] = int(slow[0].sum()) / rounds
            else:
                shift = to1.finest_shift(
                    lambda k: t8.large_blocks_per_sm(b.w16, rows_max, k),
                    b.n_streams, torch_sms(device))
                smem = t8.large_smem_bytes(rows_max, shift)
                per_sm = t8.large_blocks_per_sm(b.w16, rows_max, shift)
            b_ms, b_by = bound_ms(sum(len(x) for x in blocks) + n_sym,
                                  10 * n_sym)
            n = max(b.ulen.tolist())
            row.update({
                "ms" + tag: cuda_ms(lambda: kern(b), 3),
                "ms_at_plain_rounds" + tag: cuda_ms(
                    lambda: kern(b, PLAIN_ROUNDS), 3),
                "plain_ms" + tag: plain_ms,
                "bound_ms" + tag: b_ms, "streams" + tag: b.n_streams,
                "symbols" + tag: n_sym, "rows" + tag: rows_max,
                "chain_rounds" + tag: n - (nway - 1) * (n // nway),
                "smem_bytes" + tag: smem, "streams_per_sm" + tag: per_sm,
                "bucket_slots" + tag: 1 << shift})
            if not tag:
                row["bound_by"] = b_by
        row["ns_per_round_hifi"] = row["ms_hifi"] / row[
            "chain_rounds_hifi"] * 1e6
        # a whole 64 KiB stream, every output
        raw, enc = leg3[wire + "_spill"]
        b = frame(wire, [enc])
        got, _, e = held(key, kern, plain, b, -1, "a whole 64 KiB stream")
        err = max(err, e)
        require(got[0].cpu().numpy().tobytes() == raw,
                f"{key}: the 64 KiB stream != raw")
        row["whole_stream"] = {"bytes": len(raw),
                               "rows": int(b.tables.n_rows[0]),
                               "match": True}
        row["max_abs_err"] = err
        rows.append(row)
    return rows


X4_VARIANTS = {"ring": True, "slot": False}   # X4's output windows


def _inflate_vs_plain(ti, b, what):
    """Both variants of kernel X4 and its plain version on batch b: the
    same refusals, and where they accept, the same bytes produced, tokens
    and bytes.  Returns (the refusals, the plain version's host-clock ms,
    the largest byte difference over the accepted members, the ring
    variant's output on the host)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.time()
    ref, rst = ti.inflate_plain(b)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    rerr = ti.corrupt(b, rst)
    ok = ~rerr
    k = torch.arange(b.total_out, device=ref.device)
    keep = ok[torch.searchsorted(b.out_off, k, right=True) - 1]
    err, outs = 0, {}
    for name, ring in X4_VARIANTS.items():
        got, gst = ti.inflate_cuda(b, ring=ring)
        require(torch.equal(ti.corrupt(b, gst), rerr),
                f"inflate {name} != plain ({what}: refusals)")
        require(torch.equal(gst[ok, 1:3], rst[ok, 1:3]), f"inflate {name} "
                f"!= plain ({what}: bytes produced, tokens)")
        require(torch.equal(got[keep], ref[keep]), f"inflate {name} != "
                f"plain ({what}: bytes)")
        if bool(keep.any()):
            err = max(err, int((got[keep].long() - ref[keep].long()).abs()
                               .max()))
        outs[name] = got
    return rerr.cpu().tolist(), plain_ms, err, outs["ring"].cpu().numpy()


def _x4_case(ti, what, b, want, device):
    """Both X4 variants over batch b, whose members' bytes are `want`:
    each output equal to them, then each timed in turns.  Returns the
    case's notes: the variant ring_fits chooses, and each variant's ms,
    ns a step of the longest member, blocks an SM and waves."""
    sms = torch_sms(device)
    offs = b.out_off.cpu().numpy()
    steps = 0
    for name, ring in X4_VARIANTS.items():
        out, st = ti.inflate_cuda(b, ring=ring)
        require(not bool(ti.corrupt(b, st).any()),
                f"inflate {name}: {b.n_members} members refused")
        h = out.cpu().numpy()
        require(all(h[o:o + len(w)].tobytes() == w
                    for o, w in zip(offs, want)),
                f"inflate {name}: {b.n_members} members != their bytes")
        steps = int(st[:, 3].max())
    ms, turns = in_turns({k: (lambda r=r: ti.inflate_cuda(b, ring=r))
                          for k, r in X4_VARIANTS.items()}, 3)
    case = {"batch": what, "members": b.n_members, "longest_steps": steps,
            "chosen": "ring" if ti.ring_fits(b.n_members, device)
            else "slot", "ms": ms, "turns_ms": turns}
    for k, r in X4_VARIANTS.items():
        per_sm = ti.blocks_per_sm(ring=r)
        case[k] = {"ms": ms[k], "ns_per_step": ms[k] * 1e6 / steps,
                   "blocks_per_sm": per_sm,
                   "waves": -(-b.n_members // (per_sm * sms))}
    return case


def inflate_vs_plain(device, bgzf, leg12_members, launches,
                     n_first: int = 2):
    """Phase 6 for X4, both variants (the output window in a shared-memory
    ring, and in the member's slot): each against the plain version on
    inflate_members() (the refused ones refused by both, the others
    byte-equal, with their bytes produced and tokens), on
    ring_edge_members() and on leg 7's members at their full size (the
    first n_first and the one whose decode takes the most steps), each
    also equal to its bytes; then each equal to the raw bytes and timed,
    in turns, over leg 7's members (which ring_fits gives the slot
    variant), over the first of them that fit one wave of the ring and
    over leg 12's members (`leg12_members`: payloads and bytes; both
    given the ring).  Returns the kernels line's row: ms and the rest
    for leg 7's batch in the variant chosen for it."""
    from htslib_tpu_torch.ops import inflate as ti
    small = inflate_members()
    b = ti.frame_members([m[1] for m in small], [m[2] for m in small], device)
    gerr, plain_ms, err, gh = _inflate_vs_plain(ti, b, "small members")
    require(gerr == [m[3] is None for m in small], "inflate: refused members")
    offs = b.out_off.cpu().numpy()
    for (name, _, size, want), o in zip(small, offs):
        if want is not None:
            require(gh[o:o + size].tobytes() == want, f"inflate {name}")
    edge = ring_edge_members()
    eb = ti.frame_members([m[1] for m in edge], [m[2] for m in edge], device)
    eerr, _, err_edge, eh = _inflate_vs_plain(ti, eb, "ring-edge members")
    require(not any(eerr), "inflate: ring-edge members refused")
    for (name, _, _, want), o in zip(edge, eb.out_off.cpu().numpy()):
        require(eh[o:o + len(want)].tobytes() == want, f"inflate {name}")

    payloads, pieces = bgzf
    big = ti.frame_members(payloads, [len(p) for p in pieces], device)
    out, st = ti.inflate_cuda(big)
    require(not bool(ti.corrupt(big, st).any()), "inflate: leg 7 refused")
    st = st.cpu().numpy()
    pick = list(range(n_first))
    pick.append(int(np.argmax(st[:, 3])))
    sub = ti.frame_members([payloads[i] for i in pick],
                           [len(pieces[i]) for i in pick], device)
    serr, plain_big_ms, err_big, sh = _inflate_vs_plain(ti, sub,
                                                        "leg 7 members")
    require(not any(serr), "inflate: leg 7 members refused")
    for i, o in zip(pick, sub.out_off.cpu().numpy()):
        require(sh[o:o + len(pieces[i])].tobytes() == pieces[i],
                f"inflate: leg 7 member {i}")
    wave = ti.blocks_per_sm(ring=True) * torch_sms(device)
    cases = [_x4_case(ti, "leg 7", big, pieces, device)]
    if wave < big.n_members:
        one = ti.frame_members(payloads[:wave],
                               [len(p) for p in pieces[:wave]], device)
        cases.append(_x4_case(ti, f"leg 7's first {wave}", one,
                              pieces[:wave], device))
    pl12, want12 = leg12_members
    cases.append(_x4_case(ti, "leg 12", ti.frame_members(
        pl12, [len(w) for w in want12], device), want12, device))
    require(len({c["chosen"] for c in cases}) == 2,
            "inflate: the phase's cases do not lie on both sides of "
            "ring_fits")
    chosen = cases[0][cases[0]["chosen"]]
    ms = chosen["ms"]
    n_in, n_out = sum(map(len, payloads)), sum(map(len, pieces))
    b_ms, b_by = bound_ms(n_in + n_out, 0)
    return {
        "name": "inflate", "route": "cuda",
        "source": "htslib_tpu_torch/csrc/inflate.cu",
        "replaces": "htslib_tpu/ops/inflate.py:429",
        "launches": launches["inflate"] + launches["inflate_slot"],
        "launches_ring": launches["inflate"],
        "launches_slot": launches["inflate_slot"],
        "max_abs_err": max(err, err_big, err_edge),
        "ms": ms, "plain_ms": plain_ms, "plain_members": len(small),
        "plain_leg7_members": pick,
        "plain_leg7_steps": [int(st[i, 3]) for i in pick],
        "plain_leg7_ms": plain_big_ms,
        "ms_at_plain_members": cuda_ms(lambda: ti.inflate_cuda(b), 3),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "members": big.n_members, "in_bytes": n_in, "out_bytes": n_out,
        "tokens": int(st[:, 2].sum()),
        "ns_per_token": ms * 1e6 / int(st[:, 2].sum()),
        "MBps": n_out / ms / 1e3, "chain_rounds": int(st[:, 3].max()),
        "variant": cases[0]["chosen"], "ns_per_step": chosen["ns_per_step"],
        "smem_bytes": ti.smem_bytes(ring=cases[0]["chosen"] == "ring"),
        "smem_bytes_ring": ti.smem_bytes(ring=True),
        "smem_bytes_slot": ti.smem_bytes(ring=False),
        "blocks_per_sm": chosen["blocks_per_sm"],
        "streams_per_sm": chosen["blocks_per_sm"], "waves": chosen["waves"],
        "cases": cases, "ring_edge_members": [m[0] for m in edge],
        "note": "XLA code of the JAX package (no Pallas kernel) that the "
                "port hand-writes; two variants (ring: the output window "
                "in shared memory; slot: in the member's slot), ring_fits "
                "choosing the ring while a batch fits one wave of it; ms "
                "and the rest are leg 7's batch in its variant, cases each "
                "side of the choice in both; chain_rounds is the longest "
                "member's steps, ns_per_step the launch's time over them "
                "(its waves included)", "match": True}


def leg16_vs_plain(device, l16: dict, launches16: dict) -> dict:
    """Phase 6 at leg 16's shapes: B1 over 16a's packed sequences laid
    end to end ([1, T], gathered again here from the stream on the host),
    X5 over 16a's stream and X4 over 16a's members, each against its
    plain version on the same card tensors (X4's plain version over a
    member of the stream's first LEG16_PLAIN_BYTES deflated at the
    leg's level: the plain inflate takes a millisecond or two a step,
    and a whole member has 8,000-38,000), then timed.  Returns, by row
    name, what goes into each kernels-line row's "leg16"."""
    import torch

    from htslib_tpu_torch.bgzf import member_payload, scan_blocks
    from htslib_tpu_torch.ops import bam2sam as tb
    from htslib_tpu_torch.ops import inflate as ti
    from htslib_tpu_torch.ops import seqfmt as ts
    st = l16["stages"]
    payload = st["payload"]
    pl = np.frombuffer(payload, np.uint8)
    packed = packed_seqs(payload, stream_fields(payload))
    t = len(packed)
    p_t = torch.from_numpy(packed).to(device).view(1, t)
    got = ts.nibble_to_base_cuda(p_t)
    want = ts.nibble_to_base_plain(p_t)
    require(torch.equal(got, want), "leg 16: B1 != plain")
    require(got.cpu().numpy().tobytes() == st["bases"],
            "leg 16: B1 here != 16a's bases")
    out = {}
    b_ms, b_by = bound_ms(3 * t, 0)
    out["nibble_to_base"] = {
        "shape": [1, t], "max_abs_err": 0,
        "ms": cuda_ms(lambda: ts.nibble_to_base_cuda(p_t), 20),
        "plain_ms": cuda_ms(lambda: ts.nibble_to_base_plain(p_t), 5),
        "bound_ms": b_ms, "bound_by": b_by,
        "launches": launches16.get("nibble_to_base", 0)}

    u, n = len(payload), len(st["offs"])
    pay_t = torch.from_numpy(pl.copy()).to(device)
    got = tb.record_scan_cuda(pay_t, u // 36 + 1)
    want = tb.record_scan_plain(pay_t, u // 36 + 1)
    for g, w, what in zip(got, want, ("offsets", "sizes", "n")):
        require(torch.equal(g, w), f"leg 16: X5 != plain ({what})")
    torch.cuda.synchronize()
    t0 = time.time()
    tb.record_scan_plain(pay_t, u // 36 + 1)
    plain_ms = (time.time() - t0) * 1e3
    b_ms, b_by = bound_ms(u + 8 * n + 4, 6 * n)
    out["record_scan_seg"] = {
        "bytes": u, "records": n, "max_abs_err": 0,
        "ms": cuda_ms(lambda: tb.record_scan_cuda(pay_t, u // 36 + 1), 20),
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "launches": launches16.get("record_scan_seg", 0)}

    raw = np.frombuffer(l16["bam_file"], np.uint8)
    tbl = scan_blocks(raw)
    data = np.flatnonzero(tbl.usizes > 0)
    pays = [member_payload(raw, int(tbl.coffsets[i]), int(tbl.csizes[i]))
            for i in data]
    big = ti.frame_members(pays, [int(tbl.usizes[i]) for i in data],
                           device)
    outb, stb = ti.inflate_cuda(big)
    require(not bool(ti.corrupt(big, stb).any()), "leg 16: X4 refused")
    head = payload[:LEG16_PLAIN_BYTES]
    one = ti.frame_members([deflate_raw(head)], [len(head)], device)
    gerr, plain_ms, err, gh = _inflate_vs_plain(ti, one, "leg 16 member")
    require(not any(gerr), "leg 16: X4's member refused")
    require(gh.tobytes() == head, "leg 16: X4's member != its bytes")
    n_in, n_out = sum(map(len, pays)), int(tbl.usizes.sum())
    b_ms, b_by = bound_ms(n_in + n_out, 0)
    out["inflate"] = {
        "members": big.n_members, "max_abs_err": err,
        "ms": cuda_ms(lambda: ti.inflate_cuda(big), 5),
        "variant": "ring" if ti.ring_fits(big.n_members, device)
        else "slot", "plain_ms": plain_ms,
        "plain_member_bytes": len(head),
        "plain_member_steps": int(ti.inflate_cuda(one)[1][0, 3]),
        "ms_at_plain_member": cuda_ms(lambda: ti.inflate_cuda(one), 5),
        "bound_ms": b_ms, "bound_by": b_by,
        "launches": launches16.get("inflate", 0)
        + launches16.get("inflate_slot", 0)}
    return out


def probes_vs_plain(device, encs, launches):
    """Phase 6 for the probes' kernels: P1 at the script's shapes (256
    chains of 4 states, 512 rounds) and P2 in each mode over the first
    BLOCKS of leg 2's streams at SEG rounds, each against its plain
    version on the same card tensors; with times.
    Each ms goes through its wrapper (whose check waits for the card),
    launch_ms is the kernel launched directly; no single PyTorch call
    computes either chain, so library_ms is None (P1's row gives the
    probe's own yardstick, a chain of 512 torch.gather calls, apart; P2's
    full row B2's decode of the same streams and rounds launched directly,
    b2_launch_ms, beside the full round it ablates).  Returns their
    rows."""
    import torch

    from htslib_tpu_torch import _build
    from htslib_tpu_torch import probe_pallas_gather as pg
    from htslib_tpu_torch import probe_rans_ablate as pa
    from htslib_tpu_torch.ops.rans_nx16 import frame_streams
    rows = []
    cum, freqs, packed, x0 = pg.make_inputs()
    cum, freqs, x0 = (torch.from_numpy(a).to(device) for a in (cum, freqs,
                                                                x0))
    packed = torch.from_numpy(packed.view(np.int32)).to(device)
    got = pg.resolve_cmp_cuda(cum, freqs, x0)
    torch.cuda.synchronize()
    t0 = time.time()
    want = pg.resolve_cmp_plain(cum, freqs, x0)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    require(torch.equal(got, want), "P1 kernel != plain")
    lib = _build.load("resolve_cmp")
    out = torch.empty_like(x0)

    def direct():
        _build.check(lib, lib.resolve_cmp_launch(
            cum.data_ptr(), freqs.data_ptr(), x0.data_ptr(), out.data_ptr(),
            pg.G, pg.ROUNDS, _build.stream_handle(cum)), "resolve_cmp")

    n = pg.G * pg.NSTATES
    # the bounds and frequencies read once, the states in and out; a
    # lookup: the mask, a search of 256 bounds (8 compares), the shift,
    # multiply, add and subtract
    b_ms, b_by = bound_ms(4 * (cum.numel() + freqs.numel() + 2 * n),
                          13 * n * pg.ROUNDS)
    rows.append({
        "name": "resolve_cmp", "route": "cuda",
        "source": "htslib_tpu_torch/csrc/resolve_cmp.cu",
        "replaces": "scripts/probe_pallas_gather.py:135",
        "launches": launches["resolve_cmp"],
        "max_abs_err": int((got.long() - want.long()).abs().max()),
        "ms": cuda_ms(lambda: pg.resolve_cmp_cuda(cum, freqs, x0), 20),
        "launch_ms": cuda_ms(direct, 50), "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "torch_gather_chain_ms": cuda_ms(lambda: pg.gather_chain(packed,
                                                                 x0), 3),
        "chains": pg.G, "states": pg.NSTATES, "chain_rounds": pg.ROUNDS,
        "match": True})

    b = frame_streams(encs[:pa.BLOCKS], device)
    lanes = pa.BLOCKS * pa.NWAY
    for mode in pa.MODES:
        key = pa.launch_key(mode)
        got = pa.ablate_cuda(b, mode)
        torch.cuda.synchronize()
        t0 = time.time()
        want = pa.ablate_plain(b, mode)
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3
        # states are u32 bits: compare them as such
        err = max(int(((g.long() & 0xFFFFFFFF) - (w.long() & 0xFFFFFFFF))
                      .abs().max()) for g, w in zip(got, want))
        require(err == 0, f"P2 {mode} kernel != plain")
        # the words each stream's farthest cursor passed, the tables where
        # the mode reads them and the states in; the symbols, states and
        # cursors out
        words = int(got[2].view(pa.BLOCKS, pa.NWAY).long().max(1)
                    .values.sum())
        n_in = 2 * words + 4 * lanes + (4 * b.freqs.numel() if mode in (
            "full", "no_select", "no_scan") else 0)
        n_out = 4 * lanes * (pa.SEG + 2)
        b_ms, b_by = bound_ms(n_in + n_out,
                              pa.OPS_PER_ROUND[mode] * lanes * pa.SEG)
        rows.append({
            "name": key, "route": "cuda",
            "source": "htslib_tpu_torch/csrc/rans_ablate.cu",
            "replaces": "scripts/probe_rans_ablate.py:163",
            "launches": launches[key], "max_abs_err": err,
            "ms": cuda_ms(lambda: pa.ablate_cuda(b, mode), 5),
            "launch_ms": cuda_ms(pa.launcher(b, mode), 10),
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "streams": pa.BLOCKS,
            "chain_rounds": pa.SEG, "match": err == 0})
        if mode == "full":
            rows[-1]["b2_launch_ms"] = cuda_ms(pa.b2_launcher(b), 10)
    return rows


def torch_sms(device) -> int:
    """The card's SMs."""
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count


def record_scan_vs_plain(device, chain, n_chain, varied, launches):
    """Phase 6 for X5: both designs (the serial kernel and the segmented
    kernels) against the plain version (the JAX loop walked by the host)
    on leg 8's two payloads, on scan_streams' edge streams made from them,
    and on the segmented walk's edges at its segments made from the
    varied stream (seg_edge_streams: crafted false entries, a record
    longer than three segments, negative, -4 and wrapping lengths and
    max_records in a segment's middle, 0-4 byte payloads, a length not a
    multiple of 16); both timed over leg 8's chain and varied payloads.
    Returns the kernels line's two rows."""
    import torch

    from htslib_tpu_torch.ops import bam2sam as tb
    streams = scan_streams(varied, N_VARIED, chain, n_chain)
    seg_edges = seg_edge_streams(varied, N_VARIED, 1 << tb.SEG_SHIFT)
    streams.update({"seg_" + k: v for k, v in seg_edges.items()})
    edge_stats = {}
    for name, (payload, n) in streams.items():
        t = torch.from_numpy(np.frombuffer(payload + b"\0", np.uint8)
                             [:len(payload)].copy()).to(device)
        want = tb.record_scan_plain(t, n)
        for seg in (False, True):
            stats = torch.zeros(4, dtype=torch.int32, device=device)
            got = tb.record_scan_cuda(t, n, segmented=seg, stats=stats)
            for g, w, what in zip(got, want, ("offsets", "sizes", "n")):
                require(torch.equal(g, w), f"record_scan kernel != plain "
                        f"({name}, segmented {seg}: {what})")
            if seg and name.startswith("seg_"):
                edge_stats[name] = stats.tolist()
    # the edges reach what they were made for (stats: segments, segments
    # walked again, serial-tail steps, segments verified)
    require(edge_stats["seg_false_few"][1:3] == [3, 0],
            "record_scan: the three false entries were not walked again")
    require(edge_stats["seg_false_all"][1] == 16
            and edge_stats["seg_false_all"][2] > 0,
            "record_scan: the false entries past the rewalks did not take "
            "the serial tail")
    for name in ("seg_neg_mid", "seg_minus4_mid", "seg_wrap_mid"):
        require(edge_stats[name][2] > 0,
                f"record_scan: {name} did not take the serial tail")
    b_ms, b_by = bound_ms(len(chain) + 8 * n_chain + 4, 6 * n_chain)
    note = ("XLA code of the JAX package (no Pallas kernel) that the port "
            "hand-writes; plain_ms is the host's walk")
    rows = []
    for key, seg in (("record_scan", False), ("record_scan_seg", True)):
        timed = {}
        for what, payload, n in (("chain", chain, n_chain),
                                 ("varied", varied, N_VARIED)):
            t = torch.from_numpy(np.frombuffer(payload, np.uint8).copy()
                                 ).to(device)
            stats = torch.zeros(4, dtype=torch.int32, device=device)
            ms = cuda_ms(lambda: tb.record_scan_cuda(t, n, segmented=seg,
                                                     stats=stats),
                         5 if not seg else 20)
            timed[what] = (ms, stats.tolist(), t)
        ms, stats, t = timed["chain"]
        torch.cuda.synchronize()
        t0 = time.time()
        tb.record_scan_plain(t, n_chain)
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3
        row = {
            "name": key, "route": "cuda",
            "source": "htslib_tpu_torch/csrc/record_scan.cu",
            "replaces": "htslib_tpu/ops/bam2sam.py:34",
            "launches": launches[key], "max_abs_err": 0,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "records": n_chain,
            "bytes": len(chain), "ns_per_record": ms * 1e6 / n_chain,
            "varied_ms": timed["varied"][0],
            "varied_ns_per_record": timed["varied"][0] * 1e6 / N_VARIED,
            "edge_streams": sorted(streams), "note": note, "match": True}
        if seg:
            row.update({
                "design": "segmented: guessed entries, verified exactly",
                "segment_bytes": 1 << tb.SEG_SHIFT,
                "segments": stats[0], "rewalks": stats[1],
                "serial_tail_steps": stats[2], "verified_segments": stats[3],
                "varied_stats": timed["varied"][1], "edge_stats": edge_stats,
                "seg_min_bytes": tb.SEG_MIN_BYTES})
        else:
            row.update({"design": "serial: one thread walks the chain",
                        "window_bytes": _export(tb, "window_bytes")})
        rows.append(row)
    return rows


def probaln_vs_plain(device, hmm_calls, launches):
    """Phase 6 for X6: over each of leg 9's HMM calls (its (d, e)
    groups), the kernel against its plain version on the card in float64
    and in float32, equal; the float32 run within +/-1 phred of the
    float64 one (Pr and q).  Each group's time in both types, with how
    many of its reads ran a warp each and a thread each, beside the same
    reads all run a thread each (the design before the warp variant: the
    same thread kernel), in turns.  Times and the bound are summed over
    the groups.  Returns the kernels line's row."""
    import torch

    from htslib_tpu_torch.ops import probaln as tp
    row = {"ms": 0.0, "ms_f32": 0.0, "ms_all_thread": 0.0,
           "ms_f32_all_thread": 0.0, "plain_ms": 0.0, "cells": 0,
           "reads": 0, "bytes": 0, "groups": []}
    for args, kw in hmm_calls:
        refs, queries, quals = args
        outs = {}
        group = {"d": kw["d"]}
        for dt in (np.float64, np.float32):
            arrays, J = tp.pad_batch(refs, queries, quals, dtype=dt,
                                     bws=kw["bws"])
            a = [torch.from_numpy(x).to(device) for x in arrays]
            layout = {}
            got = tp.probaln_cuda(*a, J, d=kw["d"], e=kw["e"],
                                  layout=layout)
            torch.cuda.synchronize()
            t0 = time.time()
            want = tp.probaln_plain(*a, J, d=kw["d"], e=kw["e"])
            torch.cuda.synchronize()
            plain_ms = (time.time() - t0) * 1e3
            key = "f64" if dt == np.float64 else "f32"
            for g, w, what in zip(got, want, ("Pr", "states", "q")):
                require(torch.equal(g, w), f"probaln kernel != plain ({key} "
                        f"{what}, d={kw['d']:g})")
            outs[key] = got
            no_warp = torch.zeros(len(arrays[3]), dtype=torch.bool,
                                  device=device)
            ms, _ = in_turns({
                "new": lambda: tp.probaln_cuda(*a, J, d=kw["d"], e=kw["e"]),
                "all_thread": lambda: tp.launch(*a, kw["d"], kw["e"],
                                                no_warp)}, 3)
            sfx = "" if dt == np.float64 else "_f32"
            row["ms" + sfx] += ms["new"]
            row["ms" + sfx + "_all_thread"] += ms["all_thread"]
            group.update({"ms" + sfx: ms["new"],
                          "ms" + sfx + "_all_thread": ms["all_thread"]})
            if dt == np.float64:
                row["plain_ms"] += plain_ms
                rlen, qlen, bw = arrays[1], arrays[3], arrays[5]
                cells = int((qlen.astype(np.int64) * (2 * bw + 2)).sum())
                row["cells"] += cells
                row["reads"] += len(qlen)
                row["bytes"] += int(rlen.sum() + 14 * qlen.sum()
                                    + 16 * len(qlen))
                group.update({"reads": len(qlen), "J": J,
                              "Q": int(qlen.max()), "cells": cells,
                              "thread_reads": layout["thread_reads"],
                              "warp_reads": layout["warp_reads"],
                              "ns_per_cell": ms["new"] * 1e6 / cells})
        row["groups"].append(group)
        d_pr = (outs["f64"][0] - outs["f32"][0]).abs().max()
        d_q = (outs["f64"][2].int() - outs["f32"][2].int()).abs().max()
        require(int(d_pr) <= 1 and int(d_q) <= 1,
                f"probaln float32 beyond 1 phred of float64 (Pr {int(d_pr)}"
                f", q {int(d_q)})")
    require(any(g["warp_reads"] for g in row["groups"])
            and any(g["thread_reads"] for g in row["groups"]),
            "probaln: the groups do not lie on both sides of split_reads")
    tb_ms = row["bytes"] / HBM_BYTES_S * 1e3
    to_ms = BAQ_OPS_PER_CELL * row["cells"] / FP64_OPS_S * 1e3
    row.update({
        "name": "probaln", "route": "cuda",
        "source": "htslib_tpu_torch/csrc/probaln.cu",
        "replaces": "htslib_tpu/ops/probaln.py:50",
        "launches": launches["probaln"] + launches["probaln_warp"],
        "launches_thread": launches["probaln"],
        "launches_warp": launches["probaln_warp"], "max_abs_err": 0,
        "bound_ms": max(tb_ms, to_ms),
        "bound_by": "bytes" if tb_ms >= to_ms else "operations",
        "library_ms": None, "ns_per_cell": row["ms"] * 1e6 / row["cells"],
        "bound_note": f"{BAQ_OPS_PER_CELL} float64 operations a band cell "
                      "at the data sheet's 34 TFLOP/s",
        "warp_qlen": tp.WARP_QLEN, "thread_min_reads": tp.THREAD_MIN_READS,
        "note": "XLA code of the JAX package (no Pallas kernel) that the "
                "port hand-writes; float64 (ms_f32: float32); reads shorter "
                "than warp_qlen run a thread each where a call holds "
                "thread_min_reads of them, every other read a warp "
                "(probaln_warp_kernel); *_all_thread: every read a thread",
        "match": True})
    return row


def in_turns(fns: dict, iters: int):
    """({name: mean ms}, {name: [ms of each turn]}) of each callable,
    timed in turns forwards and back (A B .. B A)."""
    order = list(fns) + list(fns)[::-1]
    turns = {k: [] for k in fns}
    for k in order:
        turns[k].append(cuda_ms(fns[k], iters))
    return {k: sum(v) / len(v) for k, v in turns.items()}, turns


def o1_table_notes(b, offs, qb):
    """Of kernel B5 (qb None) or B6 on batch b: its shared memory a block,
    the streams one SM holds, the slow buckets of stream 0 and the share
    of rounds in which some state's bucket was slow (its lookup took the
    bucket's map)."""
    import torch

    from htslib_tpu_torch.ops import rans_nx16_o1 as to1
    slow = torch.zeros(b.n_streams, dtype=torch.int32, device=offs.device)
    to1.rans_o1_cuda(b, -1, offs, qb, slow)
    n = b.ulen.long()
    return {"smem_bytes": to1.o1_smem_bytes(b.tables, qb is not None),
            "streams_per_sm": to1.blocks_per_sm(b.tables, qb is not None),
            "fallback_buckets": fallback_buckets(b.tables),
            "slow_share": float(slow.sum()) / float((n - 31 * (n // 32))
                                                    .sum())}


def new_kernels_vs_plain(device, raws, leg3, launches):
    """Phase 6 for kernels B9, B4 and B10: each kernel against its plain
    version on the same card tensors, with times.  B9 at full size over
    the first PLAIN_ROUNDS rounds and over whole streams on the 64 KiB
    batches; B4 and B10 over all CHAIN_ROUNDS steps.  Returns the rows of
    the kernels line."""
    import torch

    from htslib_tpu_torch.ops.huffman import (huffman_resolve_cuda,
                                              huffman_resolve_plain,
                                              make_huffman_resolve_bench)
    from htslib_tpu_torch.ops import huffman, rans_enc
    from htslib_tpu_torch.ops.rans_enc import (encode_nx16_o0_batch,
                                               frame_enc, rans_enc_cuda,
                                               rans_enc_plain)
    from htslib_tpu_torch.ops import rans_nx16
    from htslib_tpu_torch.ops.rans_nx16 import (make_resolve_bench,
                                                rans_resolve_cuda,
                                                rans_resolve_plain)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.time() - t0) * 1e3

    rows = []
    b = frame_enc(raws, device)
    got = rans_enc_cuda(b, PLAIN_ROUNDS)
    ref, plain_ms = timed(lambda: rans_enc_plain(b, PLAIN_ROUNDS))
    for g, r, what in zip(got, ref, ("words", "states", "counts")):
        require(torch.equal(g, r), f"rans_nx16_o0_encode kernel != plain "
                f"over {PLAIN_ROUNDS} rounds ({what})")
    err = int((got[0].long() - ref[0].long()).abs().max())
    small = frame_enc(leg3["4x8_o0"][2] + leg3["nx16_o1"][2], device)
    for g, r, what in zip(rans_enc_cuda(small), rans_enc_plain(small),
                          ("words", "states", "counts")):
        require(torch.equal(g, r), "rans_nx16_o0_encode kernel != plain "
                f"on whole 64 KiB streams ({what})")
    edge_raw = enc_edge_streams()
    edge = frame_enc(edge_raw, device)
    for g, r, what in zip(rans_enc_cuda(edge), rans_enc_plain(edge),
                          ("words", "states", "counts")):
        require(torch.equal(g, r), "rans_nx16_o0_encode kernel != plain "
                f"on the edge streams ({what})")
    require(encode_nx16_o0_batch(edge_raw, device=device)
            == [_encode(d) for d in edge_raw],
            "rans_nx16_o0_encode edge streams != host codec")
    f = edge.freqs
    edge_note = {"lengths": [len(d) for d in edge_raw],
                 "f1_symbols": int((f == 1).sum()),
                 "one_symbol_streams": int((f == 4096).sum()),
                 "match": True}
    full = rans_enc_cuda(b)
    n_sym = sum(len(r) for r in raws)
    # bytes: the symbols in, the emitted words and final states out; per
    # symbol: table load, compare, select, shift, divide, remainder,
    # shift, two adds, ballot, popcount and store (12 operations: the
    # step's work, counted as the division form does it whatever the
    # kernel does it with)
    b_ms, b_by = bound_ms(n_sym + 2 * int(full[2].long().sum())
                          + 4 * full[1].numel(), 12 * n_sym)
    rows.append({
        "name": "rans_nx16_o0_encode", "route": "cuda",
        "source": "htslib_tpu_torch/csrc/rans_nx16_enc.cu",
        "replaces": "htslib_tpu/ops/rans_enc_pallas.py:89",
        "launches": launches["rans_nx16_o0_encode"], "max_abs_err": err,
        "ms": cuda_ms(lambda: rans_enc_cuda(b), 3),
        "plain_ms": plain_ms, "plain_rounds": PLAIN_ROUNDS,
        "ms_at_plain_rounds": cuda_ms(lambda: rans_enc_cuda(b, PLAIN_ROUNDS),
                                      3),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "streams": b.n_streams, "symbols": n_sym,
        "chain_rounds": -(-max(len(r) for r in raws) // 32),
        # a checkout older than these exports gives None
        "smem_bytes": _export(rans_enc, "smem_bytes"),
        "streams_per_sm": _export(rans_enc, "blocks_per_sm"),
        "edge_streams": edge_note, "match": True})

    # (launch key, bench, kernel, plain, source, TPU kernel, operations
    #  per step: B4 mask, table load, two field extracts, shift,
    #  multiply-add, compare and renormalising select (8); B10 16 compares
    #  and their sum, two table loads, shift, add, subtract, range check,
    #  order load and the five-operation mix (47))
    specs = [
        ("rans_resolve_bench", lambda: make_resolve_bench(
            G=CHAINS, rounds=CHAIN_ROUNDS, device=device)[1],
         rans_resolve_cuda, rans_resolve_plain, "rans_resolve_bench.cu",
         "rans_pallas.py:542", 8),
        ("huffman_resolve_bench", lambda: make_huffman_resolve_bench(
            L=CHAINS, rounds=CHAIN_ROUNDS, device=device)[1],
         huffman_resolve_cuda, huffman_resolve_plain, "huffman_resolve.cu",
         "huffman_pallas.py:116", 47),
    ]
    for key, bench, kern, plain, src, line, ops in specs:
        targs = bench()
        got = kern(*targs, CHAIN_ROUNDS)
        ref, plain_ms = timed(lambda: plain(*targs, CHAIN_ROUNDS))
        require(torch.equal(got, ref), f"{key} kernel != plain")
        ms = cuda_ms(lambda: kern(*targs, CHAIN_ROUNDS), 3)
        n_bytes = sum(t.numel() * t.element_size() for t in targs) \
            + got.numel() * got.element_size()
        b_ms, b_by = bound_ms(n_bytes, ops * CHAINS * CHAIN_ROUNDS)
        rows.append({
            "name": key, "route": "cuda",
            "source": f"htslib_tpu_torch/csrc/{src}",
            "replaces": f"htslib_tpu/ops/{line}",
            "launches": launches[key],
            "max_abs_err": int((got.long() - ref.long()).abs().max()),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "chains": CHAINS,
            "chain_rounds": CHAIN_ROUNDS,
            "lookups_per_s": CHAINS * CHAIN_ROUNDS / (ms / 1e3),
            "match": True})
    rows[-2].update({
        "smem_bytes": _export(rans_nx16, "resolve_smem_bytes"),
        "chains_per_sm": _export(rans_nx16, "resolve_chains_per_sm"),
        "bound_note": "8 operations a step: the canonical step's work, "
                      "counted so whatever implements it"})
    rows[-1].update({
        "smem_bytes": _export(huffman, "smem_bytes"),
        "chains_per_sm": _export(huffman, "chains_per_sm"),
        "bound_note": "47 operations a step: the canonical resolve's work, "
                      "counted so whatever implements it"})
    return rows


def _export(module, fn: str):
    """module.fn(), or None where the checkout's module lacks it."""
    f = getattr(module, fn, None)
    return f() if f else None


def leg4_parts(raws, encs, device):
    """Leg 4's host side in parts: encode_nx16_o0_batch's steps run one by
    one over leg 2's raw streams, each ended by a synchronise (a second
    pass, after the main path's): the framing (bincounts, _norm_freqs and
    the upload), the wrapper's checks and allocation, the launch and
    kernel, payload_tails' gather and download, and the headers.  Returns
    seconds by part; the output must be leg 2's host encodings."""
    import torch

    from htslib_tpu_torch import _build
    from htslib_tpu_torch.codecs.rans4x16 import _write_freq_table, u7_put
    from htslib_tpu_torch.ops import rans_enc as te
    sync = torch.cuda.synchronize
    t0 = time.perf_counter()
    b = te.frame_enc(raws, device)
    sync()
    t1 = time.perf_counter()
    words, x_f, n_emit = te.rans_enc_cuda(b)
    sync()
    t2 = time.perf_counter()
    lib = _build.load("rans_nx16_enc")
    rc = lib.rans_nx16_enc_launch(
        b.syms.data_ptr(), b.off.data_ptr(), b.ulen.data_ptr(),
        b.freqs.data_ptr(), b.cum.data_ptr(), words.data_ptr(),
        x_f.data_ptr(), n_emit.data_ptr(), b.n_streams, -1,
        _build.stream_handle(b.syms))
    _build.check(lib, rc, "rans_nx16_o0_encode")
    sync()
    t3 = time.perf_counter()
    bodies = te.payload_tails(b, words, n_emit)
    t4 = time.perf_counter()
    x_fin = x_f.cpu().numpy().view(np.uint32).astype("<u4")
    freqs = b.freqs.cpu().numpy()
    out = []
    for i, d in enumerate(raws):
        head = bytearray([0x04])
        u7_put(head, len(d))
        _write_freq_table(head, freqs[i])
        out.append(bytes(head) + x_fin[i].tobytes() + bodies[i])
    t5 = time.perf_counter()
    require(out == encs, "leg 4 parts: encodings != host codec")
    return {"frame_s": t1 - t0, "checks_alloc_s": (t2 - t1) - (t3 - t2),
            "launch_kernel_s": t3 - t2, "tails_s": t4 - t3,
            "headers_s": t5 - t4, "total_s": t5 - t0}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isfile(os.path.join(REPO, "htslib_tpu_torch",
                                       "_build.py")):
        print("chip_smoke: htslib_tpu_torch/ not found beside the script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from htslib_tpu_torch import _build

    t_whole = time.time()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = (smi.stdout.strip().splitlines()[0] if smi.returncode == 0
            else f"nvidia-smi failed: {smi.stderr.strip()}")
    print(f"card: {card}", flush=True)

    t0 = time.time()
    libs = _build.build()
    build_s = time.time() - t0
    print(f"build: {build_s:.1f} s", flush=True)
    for name, path in libs.items():
        with open(path + ".log") as fp:
            for line in fp:
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")

    t0 = time.time()
    parts = {}

    def timed(name, fn, *args):
        t = time.time()
        out = fn(*args)
        parts[name] = time.time() - t
        return out

    def streams(pool):
        raws, encs = timed("leg2_streams", lambda: leg2_streams(pool=pool))
        leg3 = timed("leg3_streams", lambda: leg3_streams(pool=pool))
        leg3.update(timed("leg6_streams", lambda: leg6_streams(
            raws, leg3, pool=pool)))
        return raws, encs, leg3

    # the rANS streams encode in one spawned pool, driven from a thread
    # of their own while this one builds the rest
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                             mp_context=ctx) as pool, \
            ThreadPoolExecutor(max_workers=1) as side:
        encoded = side.submit(streams, pool)
        batch = timed("leg1_batch", leg1_batch)
        stream = timed("bam_record_stream", bam_record_stream, batch)
        bgzf = timed("bgzf_members", bgzf_members, stream)
        varied = timed("varied_bam_stream", varied_bam_stream, N_VARIED)
        baq = timed("baq_case", baq_case, N_BAQ)
        raws, encs, leg3 = encoded.result()
    print(f"inputs: {time.time() - t0:.1f} s, parts (s; leg 2, 3 and 6's "
          "streams beside the rest) " + json.dumps(parts), flush=True)

    _build.reset_launches()
    args, secs, notes = main_path("cuda", batch, raws, encs, leg3, bgzf,
                                  varied, baq)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    hmm_calls = notes["leg9"].pop("hmm_calls")
    # leg 10b's kernels ran in its rank processes: add their launches
    for k, v in notes["launches_leg10b"].items():
        launches[k] += v
    # "X4": either variant of kernel X4
    for leg, need in (("leg7", ["X4"]),
                      ("leg8", ["record_scan_seg", "nibble_to_base"]),
                      ("leg9", ["probaln", "probaln_warp"]),
                      ("leg10a", ["nibble_to_base", "X4", "record_scan"]),
                      ("leg10b", ["nibble_to_base", "X4", "record_scan",
                                  "record_scan_seg"]),
                      ("leg11", ["nibble_to_base", "record_scan_seg"]),
                      ("leg11_ranks", ["nibble_to_base",
                                       "record_scan_seg"]),
                      ("leg12", ["X4"]), ("leg12_ranks", ["X4"]),
                      ("leg13", ["nibble_to_base", "rans4x8_o0_decode",
                                 "X1", "X5", "B2/B5", "B3/B6"]),
                      ("leg14", ["X4", "X5", "nibble_to_base",
                                 "rans4x8_o0_decode", "X1"]),
                      ("leg15", ["X4", "X5", "nibble_to_base",
                                 "rans4x8_o0_decode", "X1"]),
                      ("leg16", ["X4", "record_scan_seg",
                                 "nibble_to_base"]),
                      ("leg17", ["resolve_cmp", "rans_ablate_full",
                                 "rans_ablate_no_select",
                                 "rans_ablate_no_resolve",
                                 "rans_ablate_no_scan",
                                 "rans_ablate_only_loop",
                                 "rans_ablate_slice_cost", "X4",
                                 "rans4x8_o0_decode", "X1", "X5",
                                 "nibble_to_base"])):
        got = dict(notes["launches_" + leg])
        got["X4"] = got.get("inflate", 0) + got.get("inflate_slot", 0)
        got["X5"] = got.get("record_scan", 0) + got.get("record_scan_seg",
                                                        0)
        # a kernel with its large-table and dense variants
        for key, names in (("X1", ["rans4x8_o1"]),
                           ("B2/B5", ["rans_nx16_o0", "rans_nx16_o1"])):
            got[key] = sum(got.get(f"{n}{r}_decode", 0) for n in names
                           for r in ("", "_large", "_dense"))
        got["B3/B6"] = (got.get("rans_nx16_o0_hist", 0)
                        + got.get("rans_nx16_o1_hist", 0))
        for k in need:
            require(got.get(k, 0) >= 1, f"kernel {k} not launched in {leg}")
    # every wire of leg 11's files launched its kernel (or, for an order-1
    # table past A2_MAX rows, its dense variant): the whole files in this
    # process, 11a's shards in the ranks
    from htslib_tpu_torch.cram.batch import WIRE_KERNELS
    for tag, leg in (("11a", "leg11"), ("11b", "leg11"),
                     ("11a", "leg11_ranks")):
        got = notes["launches_" + leg]
        for wire in notes["leg11"][tag]["wires"]:
            if wire != "host":
                k = WIRE_KERNELS[wire]
                require(sum(got.get(k.replace("_decode", r + "_decode"), 0)
                            for r in ("", "_large", "_dense")) >= 1,
                    f"leg {tag}: wire {wire} launched no kernel in {leg}")
    print(f"main path ok: {secs}, launches {launches}", flush=True)
    print(f"leg 2 wall: {secs['leg2']:.3f} s, parts {notes['leg2']}",
          flush=True)
    print(f"leg 3 wall: {secs['leg3']:.3f} s", flush=True)
    print(f"leg 4 wall: {secs['leg4']:.3f} s, timing "
          f"{notes['leg4_timing']}", flush=True)
    print(f"leg 5 wall: {secs['leg5']:.3f} s, lookups/s: rANS "
          f"{notes['rans_resolve_lookups_per_s']:.6g}, Huffman "
          f"{notes['huffman_resolve_lookups_per_s']:.6g}", flush=True)
    print(f"leg 6 wall: {secs['leg6']:.3f} s, parts {notes['leg6']}",
          flush=True)
    print(f"leg 7 wall: {secs['leg7']:.3f} s, {notes['leg7']}", flush=True)
    print(f"leg 8 wall: {secs['leg8']:.3f} s, {notes['leg8']}", flush=True)
    print(f"leg 9 wall: {secs['leg9']:.3f} s, {notes['leg9']}", flush=True)
    print(f"leg 10a wall (NCCL, a world of one): {secs['leg10a']:.3f} s, "
          f"{notes['leg10a']}", flush=True)
    ranks = notes["leg10b"].pop("ranks")
    rank_shapes = notes["leg10b"].pop("rank_shapes")
    print(f"leg 10b wall ({N_RANKS} gloo ranks on cuda:0): "
          f"{secs['leg10b']:.3f} s, {notes['leg10b']}", flush=True)
    for r, rank in enumerate(ranks):
        print(f"leg 10b rank {r}: {rank}", flush=True)
    l11 = notes["leg11"]
    print(f"leg 11 wall (this process): {secs['leg11']:.3f} s, inputs "
          f"{l11['inputs_s']:.3f} s", flush=True)
    for tag, what in (("11a", "CRAM 3.0 with a reference"),
                      ("11b", "CRAM 3.1, no reference")):
        leg = {k: v for k, v in l11[tag].items()
               if k not in ("sam", "path", "ref", "bam")}
        print(f"leg {tag} ({what}): {leg}", flush=True)
    print(f"leg 11a over {N_RANKS} shards in leg 10b's ranks: SAM "
          f"{l11['check']['shards_sam_MBps']:.6g} MB/s; each rank's "
          "cram_decode_s " + json.dumps([r["cram_decode_s"] for r in ranks])
          + ", parts " + json.dumps([r["cram_parts_s"] for r in ranks]),
          flush=True)
    print(f"leg 11 check: {l11['check']}", flush=True)
    l12 = notes["leg12"]
    leg12_members = l12.pop("x4_members")
    print(f"leg 12 wall (this process): {secs['leg12']:.3f} s, "
          + json.dumps({k: v for k, v in l12.items()
                        if k not in ("text", "header", "path")}), flush=True)
    print(f"leg 12a BCF -> VCF on the card ({N_VCF} records, {N_SAMPLES} "
          f"samples): {l12['decode_s']:.3f} s, {l12['vcf_MBps']:.6g} MB/s "
          f"of VCF, parts {json.dumps(l12['parts'])}", flush=True)
    print(f"leg 12b over {N_RANKS} shards in leg 10b's ranks: VCF "
          f"{l12['check']['shards_vcf_MBps']:.6g} MB/s; each rank's "
          "bcf_decode_s " + json.dumps([r["bcf_decode_s"] for r in ranks])
          + ", parts " + json.dumps([r["bcf_parts_s"] for r in ranks]),
          flush=True)
    l13 = notes["leg13"]
    a13 = l13["13a"]
    print(f"leg 13 wall (this process): {secs['leg13']:.3f} s; "
          f"13a: {len(a13['regions'])} regions of 11a through its .crai, "
          f"{a13['containers']} containers decoded on the card in "
          f"{a13['decode_s']:.3f} s, {a13['ms_a_region']:.6g} ms a region; "
          "regions (tid, beg, end; containers, SAM bytes): " + json.dumps(
              [(r["region"], r["containers"],
                sum(len(t) for *_, t in r["runs"])) for r in a13["regions"]]),
          flush=True)
    print(f"leg 13c (11a by M5, its FASTA moved): {l13['13c']}", flush=True)
    d13 = {k: v for k, v in l13["13d"].items()
           if k not in ("sam", "path", "ref", "hist")}
    print(f"leg 13d (11b's BAM as reference-based CRAM 3.1, "
          f"device_profile): {d13}", flush=True)
    c13 = l13["check"]
    print(f"leg 13b (11a, required_fields, host decode a container a "
          f"process): {c13['fields']}", flush=True)
    print(f"leg 13e (filters over two 13a regions: region, expression, "
          f"passed, records): {c13['filter_passed']}", flush=True)
    print(f"leg 13 check: " + json.dumps(
        {k: v for k, v in c13.items()
         if k not in ("fields", "filter_passed")}), flush=True)
    l14 = notes["leg14"]
    a14, b14, c14, d14 = (l14[k] for k in ("14a", "14b", "14c", "14d"))
    print(f"leg 14 wall (this process): {secs['leg14']:.3f} s, of which "
          f"the host truths' wait {l14['check']['truth_wait_s']:.3f} s; ms "
          f"a region on the card: 14a {a14['ms_a_region']:.6g} (BAM, "
          f"{len(a14['regions'])} regions through the .bai), 14b "
          f"{b14['ms_a_region']:.6g} (BCF through its .csi), 14c "
          f"{c14['ms_a_region']:.6g} (bgzipped VCF through its .tbi)",
          flush=True)
    print("leg 14 index builds (s): " + json.dumps({
        "14a_rewrite_with_bai": a14["rewrite_s"],
        "14a_build_bam_index_bai": a14["bai_build_s"],
        "14a_build_bam_index_csi14": a14["csi_build_s"],
        "14b_bcf_write_with_csi": b14["write_s"],
        "14b_bcf_index_build": b14["index_build_s"],
        "14c_bgzip": c14["bgzip_s"], "14c_tabix_tbi": c14["tbi_build_s"],
        "14c_tabix_csi14": c14["csi_build_s"],
        "14d_bgzip_with_gzi": d14["bgzip_s"],
        "14d_fetch_64": d14["fetch_s"]}), flush=True)
    print(f"leg 14d (11a decoded with ref= the .fa.gz): "
          f"{d14['decode_s']:.3f} s, parts {json.dumps(d14['parts'])}",
          flush=True)
    print("leg 14 check: " + json.dumps(
        {**l14["check"],
         "14a_regions": [r["region"] for r in a14["regions"]],
         "14b_regions": [r["region"] for r in b14["regions"]],
         "14c_regions": [r["region"] for r in c14["regions"]]}), flush=True)
    l15 = notes["leg15"]
    print(f"leg 15 wall (this process): {secs['leg15']:.3f} s; 15a BAM -> "
          f"SAM from the file {l15['15a']['wall_s']:.3f} s, "
          f"{l15['15a']['sam_MBps']:.6g} MB/s of SAM, parts "
          + json.dumps(l15["15a"]["parts"]), flush=True)
    print("leg 15b (the same BAM over 127.0.0.1): " + json.dumps(l15["15b"]),
          flush=True)
    print("leg 15c (11a by a REF_PATH URL): " + json.dumps(l15["15c"]),
          flush=True)
    print("leg 15d (hts_open: reader, records, s by hts_open and by the "
          "direct reader; writers: reader, records, bytes, s): "
          + json.dumps(l15["15d"]), flush=True)
    print("leg 15e (FASTQ import, decoded on the card): "
          + json.dumps(l15["15e"]), flush=True)
    print("leg 15f (sam_to_bam_file, decoded on the card): "
          + json.dumps(l15["15f"]), flush=True)
    l16 = notes["leg16"]
    a16 = l16["16a"]
    print(f"leg 16 wall (this process): {secs['leg16']:.3f} s, of which "
          f"inputs {l16['inputs_s']:.3f} s; 16a mpileup_text_parallel on "
          f"{l16['records']} reads ({l16['bam_bytes']} B of BAM): "
          f"{a16['wall_s']:.3f} s, {a16['columns']} columns, "
          f"{a16['entries']} entries, {a16['entries_per_s']:.6g} entries/s, "
          f"{a16['timing']['processes']} processes, parts "
          + json.dumps(a16["timing"]) + f"; device_pileup_counts "
          f"{a16['device_counts_s']:.3f} s", flush=True)
    print("leg 16b/16c (3,000 records: BAM serial and at 3 processes, SAM "
          "serial): " + json.dumps(l16["16b"]), flush=True)
    print("leg 16 check: " + json.dumps(l16["check"]), flush=True)
    l17 = notes["leg17"]
    print(f"leg 17 wall (this process): {secs['leg17']:.3f} s; 17a P1 "
          f"{l17['17a']['lookups_per_s']:.6g} lookups/s through its "
          "wrapper, warm (B4's leg 5 chain "
          f"{notes['rans_resolve_lookups_per_s']:.6g}); 17b P2 ns a round "
          "through its wrapper, warm " + json.dumps(
              l17["17b"]["ns_a_round_with_call"]), flush=True)
    print("leg 17c (11a by REF_PATH through the reference cache): "
          + json.dumps(l17["17c"]) + "; 17d (cram_file_to_bam_stream): "
          + json.dumps(l17["17d"]), flush=True)
    print("leg 17e (the CLI): " + json.dumps(l17["17e"]), flush=True)
    print("launches by leg: " + json.dumps({k: v for k, v in notes.items()
                                            if k.startswith("launches_")}),
          flush=True)
    # each launch of csrc/rans4x8.cu's kernels (key, order-1 layout,
    # streams, rounds of the longest stream), of X5 (key, payload bytes,
    # max_records) and of X4 (key, members, the longest member's steps)
    # in legs 7-16, the ranks' apart: PERF.md reckons the launches no
    # timing covers from these shapes
    shapes = {k[len("shapes_"):]: v for k, v in notes.items()
              if k.startswith("shapes_")}
    shapes["leg10b_ranks"] = rank_shapes
    print("launch shapes: " + json.dumps(shapes), flush=True)
    for k, v in launches.items():
        require(v >= 1, f"kernel {k} not launched on the main path")
    print(f"leg 4 host side in parts: {leg4_parts(raws, encs, 'cuda')}",
          flush=True)

    t0 = time.time()
    rows = kernels_vs_plain(args[1], encs, launches)
    print(f"phase 6, B1-B3: {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    rows += leg3_kernels_vs_plain(args[1].device, leg3, launches)
    print(f"phase 6, B5-B8, X1-X3: {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    rows += new_kernels_vs_plain(args[1].device, raws, leg3, launches)
    print(f"phase 6, B9, B4, B10: {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    rows += dense_vs_plain(args[1].device, leg3, launches)
    print(f"phase 6, dense X1, X3, B5: {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    rows += large_vs_plain(args[1].device, leg3, launches)
    print(f"phase 6, large X1, X3, B5: {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    rows.append(inflate_vs_plain(args[1].device, bgzf, leg12_members,
                                 launches))
    rows[-1]["launches_leg12"] = sum(
        notes[k].get(x4, 0) for k in ("launches_leg12", "launches_leg12_ranks")
        for x4 in ("inflate", "inflate_slot"))
    print(f"phase 6, X4: {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    rows += record_scan_vs_plain(args[1].device, stream, N_RECORDS,
                                 varied, launches)
    print(f"phase 6, X5: {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    rows.append(probaln_vs_plain(args[1].device, hmm_calls, launches))
    print(f"phase 6, X6: {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    at16 = leg16_vs_plain(args[1].device, l16, notes["launches_leg16"])
    for row in rows:
        if row["name"] in at16:
            row["leg16"] = at16[row["name"]]
            row["launches_leg16"] = at16[row["name"]]["launches"]
    print(f"phase 6, leg 16's shapes (B1, X4, X5): {time.time() - t0:.1f} "
          "s", flush=True)
    t0 = time.time()
    rows += probes_vs_plain(args[1].device, encs, launches)
    for row in rows:
        if row["name"] == "inflate":
            row["launches_leg17"] = sum(notes["launches_leg17"].get(k, 0)
                                        for k in ("inflate", "inflate_slot"))
    print(f"phase 6, P1 and P2: {time.time() - t0:.1f} s", flush=True)
    # the figure the chain-bound kernels are designed against
    for row in rows:
        if "chain_rounds" in row:
            row["ns_per_round"] = row["ms"] / row["chain_rounds"] * 1e6
    # leg 2's host side: its wall time less its two kernels' times
    kern_s = sum(r["ms"] for r in rows if r["name"] in (
        "rans_nx16_o0_hist", "rans_nx16_o0_decode")) / 1e3
    print(f"leg 2 host side: {secs['leg2'] - kern_s:.4f} s of "
          f"{secs['leg2']:.4f} s (kernels B3 + B2 {kern_s * 1e3:.3f} ms)",
          flush=True)
    print(f"whole: {time.time() - t_whole:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
