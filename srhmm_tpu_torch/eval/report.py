"""Report writers reproducing the reference output formats byte-for-byte.

Recognition report: writing_header / writing_word / writing_result_word /
writing_total_result (recognition-full-fs/recognition_continuous_full_fs.c:
1019-1196; diag variant header at recognition-fs:1023).  Golden file:
reference repository test/test/result/hmm-result.txt.

Trainer text summary: writing_text (hmm-full-fs:2421-2527; diag header at
hmm-fs:2189).  Golden files: reference repository train/test/result/*.txt.

C printf quirks preserved: "Percentagen correct", int truncation of the
average frame count (word_frames /= sum with ints), "%.2f" rounding.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


def c_strftime_datetime(t: float | None = None) -> str:
    """The reference's "%d-%h-%Y %X" stamp (R1:178)."""
    return time.strftime("%d-%b-%Y %H:%M:%S", time.localtime(t))


def c_strftime_cpu(seconds: float) -> str:
    """The reference's cpu-time stamp "%d %X" with tm_mday -= 1 (T1:352-358)."""
    s = int(seconds)
    days = s // 86400
    rest = time.strftime("%H:%M:%S", time.gmtime(s % 86400))
    return f"{days:02d} {rest}"


@dataclass
class WordBlockStats:
    """Per-spoken-word bookkeeping (R1:146-160)."""

    spoken_word: str
    correct: int = 0
    error: int = 0
    second: int = 0
    word_frames: int = 0
    cpu_time: float = 0.0
    wrong_word: dict[int, int] = field(default_factory=dict)  # vocab idx -> count


class RecognitionReport:
    """Accumulates per-utterance results and renders the reference report."""

    def __init__(
        self,
        vocab_words: list[str],
        models_number: int,
        model_list_names: list[str],
        coef_model: list[float],
        cov_type: str = "full",
        date_time: str | None = None,
    ):
        self.words = vocab_words
        self.blocks: list[WordBlockStats] = []
        self.lines: list[str] = []
        if cov_type == "full":
            self.lines.append(
                "Isolated word recognition using Continuous HMM. "
                "It is considered full covariance matrix.\n"
            )
        else:
            self.lines.append(
                "Isolated word recognition using Continuous HMM "
                "(diagonal covariance matrix). It is considered a final state. \n"
            )
        self.lines.append("Algorithm used for recognition: Forward \n")
        self.lines.append(f"Number of models: {models_number}  \n")
        for i in range(models_number):
            self.lines.append(f"Model name {i + 1}: {model_list_names[i]}\n")
            self.lines.append(
                f"Weighting coefficient of model {i + 1}:{coef_model[i]:.2f}\n"
            )
        self.lines.append(
            f"Date and time: {date_time or c_strftime_datetime()} \n\n"
        )
        self._cur: WordBlockStats | None = None

    def add_utterance(
        self,
        spoken_word: str,
        ranking,
        obs_time: int,
        cpu_time: float = 0.0,
    ) -> bool:
        """Record one utterance's result. Returns True iff correct."""
        if self._cur is None or self._cur.spoken_word != spoken_word:
            self._flush()
            self.lines.append(f"\nSpoken word: {spoken_word}\n")
            self._cur = WordBlockStats(spoken_word)
        cur = self._cur
        cur.word_frames += obs_time
        cur.cpu_time += cpu_time
        win = self.words[ranking[0]]
        ok = win == spoken_word
        if ok:
            cur.correct += 1
        else:
            cur.error += 1
            cur.wrong_word[ranking[0]] = cur.wrong_word.get(ranking[0], 0) + 1
            if self.words[ranking[1]] == spoken_word:
                cur.second += 1
        return ok

    def _flush(self):
        if self._cur is None:
            return
        b = self._cur
        self.blocks.append(b)
        self.lines.append(self._result_word_block(b))
        self._cur = None

    def _result_word_block(self, b: WordBlockStats) -> str:
        total = b.correct + b.error
        per = b.correct / total
        out = [
            "\nResults: \n",
            f"Spoken word: {b.spoken_word}\n",
            f"Correct words: {b.correct}\n",
            f"Errors: {b.error}\n",
            f"Percentagen correct : {per * 100.0:.2f}%\n",
            f"Second candidate: {b.second}\n",
        ]
        if b.error != 0:
            out.append("Wrong words: \n")
            for i in range(len(self.words)):
                n = b.wrong_word.get(i, 0)
                if n:
                    out.append(
                        f"{self.words[i]}: {n} time{'' if n == 1 else 's'}\n"
                    )
        out.append(f"Average recognition time: {b.cpu_time / total:.2f} sec. \n")
        out.append(f"Average word length: {b.word_frames // total} frames \n")
        return "".join(out)

    def finalize(self) -> str:
        """Flush the last block, append the total block, return the report."""
        self._flush()
        correct = sum(b.correct for b in self.blocks)
        error = sum(b.error for b in self.blocks)
        second = sum(b.second for b in self.blocks)
        frames = sum(b.word_frames for b in self.blocks)
        cpu = sum(b.cpu_time for b in self.blocks)
        total = correct + error
        per = correct / total if total else 0.0
        self.lines.append(
            "\nConsidering all the words: \n"
            "Results: \n"
            f"Correct words: {correct}\n"
            f"Errors: {error}\n"
            f"Percentagen correct : {per * 100.0:.2f}%\n"
            f"Second candidate: {second}\n"
            f"Average recognition time: {cpu / total:.2f} sec. \n"
            f"Average word length: {frames // total} frames \n"
        )
        return "".join(self.lines)


def trainer_text_summary(
    model_file: str,
    word: str,
    states_number: int,
    param_number: int,
    mixture_numbers: list[int],
    data_files: list[str],
    threshold: float,
    exemplar_number: int,
    mean_probability: float,
    iterations: int,
    starting_time: str,
    ending_time: str,
    cpu_time: str,
    cov_type: str = "full",
) -> str:
    """writing_text (T1:2437-2526 / diag hmm-fs:2189)."""
    if cov_type == "full":
        head = (
            "Continuous HMM created using Forward Backward algorithm. "
            "It is considered full covariance matrix. It is considered a final state.\n"
        )
    else:
        head = (
            "Continuous HMM created using forward backward algorithm "
            "(diagonal covariance matrix). It is considered a final state.\n"
        )
    out = [
        head,
        f"model file: {model_file} \n",
        f"word: {word} \n",
        f"number of states: {states_number} \n",
        f"number of parameters: {param_number} \n",
    ]
    for i in range(param_number):
        out.append(f"number of mixtures {i + 1}: {mixture_numbers[i]} \n")
    for i in range(param_number):
        out.append(f"parameter {i + 1}: {data_files[i]} \n")
    out += [
        f"threshould to finish training: {threshold:f} \n",
        f"number of exemplars in training sequence: {exemplar_number} \n",
        f"mean probability: {mean_probability:f} \n",
        f"number of iterations: {iterations} \n",
        f"starting time: {starting_time} \n",
        f"ending time: {ending_time} \n",
        f"cpu time: {cpu_time} \n",
    ]
    return "".join(out)


def c_text_file_name(output_file: str) -> str:
    """The trainer's text-file naming: strtok(text_file, ".") then append
    ".txt" (T1:190-192) — truncate at the first '.' after any leading dots."""
    i = 0
    while i < len(output_file) and output_file[i] == ".":
        i += 1
    j = output_file.find(".", i)
    base = output_file[:j] if j != -1 else output_file
    return base + ".txt"
