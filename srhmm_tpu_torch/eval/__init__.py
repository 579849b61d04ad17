from .metrics import WerCounts, edit_alignment, isolated_accuracy
from .report import (
    RecognitionReport,
    c_strftime_cpu,
    c_strftime_datetime,
    c_text_file_name,
    trainer_text_summary,
)

__all__ = [
    "RecognitionReport",
    "WerCounts",
    "c_strftime_cpu",
    "c_strftime_datetime",
    "c_text_file_name",
    "edit_alignment",
    "isolated_accuracy",
    "trainer_text_summary",
]
