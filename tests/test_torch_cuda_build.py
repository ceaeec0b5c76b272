"""utils/cuda_build.py without a compiler: where each library is built."""

from speech_anonymization_tpu_torch.tools import profile_lm_megastep
from speech_anonymization_tpu_torch.utils import cuda_build


def test_variant_builds_into_its_own_library():
    """A source built with -D macros (K7's stamped build) gets a library of
    its own beside the plain one, at a path that depends only on the source,
    the headers and the flags."""
    plain = cuda_build.library_path("lm_megastep")
    stamped = cuda_build.library_path("lm_megastep", profile_lm_megastep.STAMPED)
    assert plain != stamped
    assert plain.parent == stamped.parent == cuda_build.BUILD_DIR
    assert cuda_build.library_path("lm_megastep", profile_lm_megastep.STAMPED) == stamped
    assert "lm_megastep" in cuda_build.sources()
