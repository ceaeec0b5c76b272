from .evaluator import FeatureClassifier
from .metrics import AccuracyStats, SimilarityMetricsStats
from .wer import ErrorRateStats, edit_distance_details
