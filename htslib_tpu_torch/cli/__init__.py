"""The command-line tools (the port's copy of htslib_tpu/cli/): bgzip,
tabix, htsfile and annot-tsv, each run as
`python -m htslib_tpu_torch.cli.<tool>`."""
