"""Convenience namespace: commonly used helpers re-exported from core/
(port of ``domainrag_tpu/utils/__init__.py``)."""

from ..core.config import (DATASET_CATEGORIES, DATASET_PARAMS,  # noqa: F401
                           DatasetParams, PipelineConfig,
                           get_dataset_params, get_shots_for_dataset,
                           worker_slice)
from ..core.coco import CocoAnnotations, write_coco  # noqa: F401
from ..core.imaging import (apply_resolution, clip_preprocess,  # noqa: F401
                            inpaint_mask_from_bboxes, load_rgb,
                            outpaint_keep_mask, resolve_resolution,
                            restore_resolution, scale_bboxes,
                            siglip_preprocess, style_preprocess)
from ..core.locks import atomic_save_npy, file_lock  # noqa: F401
from ..core.log import StepTimer, get_logger, maybe_trace  # noqa: F401
from ..core.manifest import Manifest  # noqa: F401
from ..core.prefetch import prefetch  # noqa: F401
from ..core.progress import ProgressReporter  # noqa: F401
