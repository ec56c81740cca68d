"""VCF/BCF variant-data layer (reference vcf.c:1-6658, htslib/vcf.h): the
port's copy of htslib_tpu/vcf/."""
from htslib_tpu_torch.vcf.header import BcfHeader  # noqa: F401
from htslib_tpu_torch.vcf.record import BcfRecord  # noqa: F401
from htslib_tpu_torch.vcf.io import (VcfReader, VcfWriter, BcfReader,  # noqa: F401
                                     BcfWriter, open_vcf)
from htslib_tpu_torch.vcf.merge import bcf_hdr_merge, bcf_translate  # noqa: F401
