"""Accuracy / WER metrics.

The reference only counts exact isolated-word hits (correct/error/second,
R2:146-160).  Continuous recognition needs word-error-rate: Levenshtein
alignment with substitution/insertion/deletion counts.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class WerCounts:
    substitutions: int = 0
    insertions: int = 0
    deletions: int = 0
    num_ref_words: int = 0

    @property
    def errors(self) -> int:
        return self.substitutions + self.insertions + self.deletions

    @property
    def wer(self) -> float:
        return self.errors / self.num_ref_words if self.num_ref_words else 0.0

    def __add__(self, other: "WerCounts") -> "WerCounts":
        return WerCounts(
            self.substitutions + other.substitutions,
            self.insertions + other.insertions,
            self.deletions + other.deletions,
            self.num_ref_words + other.num_ref_words,
        )


def edit_alignment(ref: list, hyp: list) -> WerCounts:
    """Levenshtein alignment counts (sub=1, ins=1, del=1)."""
    R, H = len(ref), len(hyp)
    # dp[i][j] = (cost, subs, ins, dels) aligning ref[:i] to hyp[:j]
    dp = [[(0, 0, 0, 0)] * (H + 1) for _ in range(R + 1)]
    for i in range(1, R + 1):
        dp[i][0] = (i, 0, 0, i)
    for j in range(1, H + 1):
        dp[0][j] = (j, 0, j, 0)
    for i in range(1, R + 1):
        for j in range(1, H + 1):
            if ref[i - 1] == hyp[j - 1]:
                cand = [(dp[i - 1][j - 1][0],) + dp[i - 1][j - 1][1:]]
            else:
                c = dp[i - 1][j - 1]
                cand = [(c[0] + 1, c[1] + 1, c[2], c[3])]
            c = dp[i][j - 1]
            cand.append((c[0] + 1, c[1], c[2] + 1, c[3]))  # insertion
            c = dp[i - 1][j]
            cand.append((c[0] + 1, c[1], c[2], c[3] + 1))  # deletion
            dp[i][j] = min(cand)
    _, s, ins, dels = dp[R][H]
    return WerCounts(s, ins, dels, R)


def isolated_accuracy(refs: list, hyps: list) -> float:
    """Exact-match accuracy for isolated-word recognition."""
    if not refs:
        return 0.0
    return sum(r == h for r, h in zip(refs, hyps)) / len(refs)
