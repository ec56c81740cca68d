"""VCF/BCF variant-data layer (reference vcf.c:1-6658, htslib/vcf.h): the
port's copy of htslib_tpu/vcf/ without merge.py (ROADMAP A12)."""
from htslib_tpu_torch.vcf.header import BcfHeader  # noqa: F401
from htslib_tpu_torch.vcf.record import BcfRecord  # noqa: F401
from htslib_tpu_torch.vcf.io import (VcfReader, VcfWriter, BcfReader,  # noqa: F401
                                     BcfWriter, open_vcf)
