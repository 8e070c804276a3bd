from .metrics import (
    auc1_tp_counts,
    correctness_matrix,
    evaluate_rows,
    evaluate_string_results,
    hit_family_codes,
    precision_recall_curve,
    recall_at,
    top1_accuracy,
    tp_cumulative,
)

__all__ = [
    "auc1_tp_counts",
    "correctness_matrix",
    "evaluate_rows",
    "evaluate_string_results",
    "hit_family_codes",
    "precision_recall_curve",
    "recall_at",
    "top1_accuracy",
    "tp_cumulative",
]
