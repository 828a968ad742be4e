"""DBoW2 ORB-vocabulary file validation.

The reference loads a DBoW2 ``TemplatedVocabulary`` text file (ORBvoc.txt,
fetched by fetch-vocabulary.sh:5-7) and builds an inverted index used for
loop detection and relocalization (thirdparty/orb-slam2/include/
ORBVocabulary.h). This port (a copy of pilotguru_tpu/vo/vocabulary.py, which
imports nothing of JAX) replaces the index with exhaustive Hamming matching
(vo/matching.py) — brute-force matching at a 2000-feature budget is one
matmul — so the file's CONTENT is unused. The ``--vocabulary_file`` CLI contract is still
honored: when a path is given, the file is parsed and validated (bad or
missing files fail loudly, exactly like the reference's loader), and the
design substitution is logged instead of silently ignoring the flag.

Text format (DBoW2 TemplatedVocabulary::loadFromTextFile): a header line
``k L scoring_id weighting_id`` followed by one node per line:
``parent_id is_leaf d_0 ... d_31 weight`` (32 descriptor bytes for ORB).
"""

from __future__ import annotations

from dataclasses import dataclass

_DESCRIPTOR_BYTES = 32


@dataclass(frozen=True)
class VocabularyInfo:
    branching_factor: int  # k
    depth_levels: int  # L
    scoring: int
    weighting: int
    num_nodes: int


def validate_dbow2_vocabulary(
    path: str, max_nodes: int | None = None
) -> VocabularyInfo:
    """Parse + validate a DBoW2 ORB vocabulary text file.

    Raises ValueError naming the problem on malformed input (the reference
    crashes with "Wrong path to vocabulary" / a failed load, System.cc).
    ``max_nodes`` bounds how many node lines are checked (None = all);
    header validation is always full.
    """
    with open(path, "r") as f:
        header = f.readline().split()
        if len(header) < 4:
            raise ValueError(
                f"vocabulary {path}: header needs 'k L scoring weighting', "
                f"got {' '.join(header) or '(empty file)'}"
            )
        try:
            k, levels, scoring, weighting = (int(tok) for tok in header[:4])
        except ValueError:
            raise ValueError(
                f"vocabulary {path}: non-integer header fields {header[:4]}"
            ) from None
        if k < 2 or levels < 1:
            raise ValueError(
                f"vocabulary {path}: implausible shape k={k} L={levels}"
            )
        if scoring < 0 or scoring > 5 or weighting < 0 or weighting > 3:
            raise ValueError(
                f"vocabulary {path}: unknown scoring={scoring} / "
                f"weighting={weighting} (DBoW2 defines scoring 0-5, "
                f"weighting 0-3)"
            )

        num_nodes = 0
        for line_no, line in enumerate(f, start=2):
            tokens = line.split()
            if not tokens:
                continue
            if max_nodes is not None and num_nodes >= max_nodes:
                num_nodes += 1  # counted but not validated
                continue
            # parent_id is_leaf 32-byte descriptor weight
            if len(tokens) != 2 + _DESCRIPTOR_BYTES + 1:
                raise ValueError(
                    f"vocabulary {path}:{line_no}: node line has "
                    f"{len(tokens)} fields, want "
                    f"{2 + _DESCRIPTOR_BYTES + 1} (parent, is_leaf, "
                    f"{_DESCRIPTOR_BYTES} descriptor bytes, weight)"
                )
            try:
                parent = int(tokens[0])
                is_leaf = int(tokens[1])
                descriptor = [int(tok) for tok in tokens[2:-1]]
                float(tokens[-1])  # weight
            except ValueError:
                raise ValueError(
                    f"vocabulary {path}:{line_no}: non-numeric node fields"
                ) from None
            if parent < -1 or is_leaf not in (0, 1):
                raise ValueError(
                    f"vocabulary {path}:{line_no}: parent={parent} "
                    f"is_leaf={is_leaf} out of range"
                )
            if any(b < 0 or b > 255 for b in descriptor):
                raise ValueError(
                    f"vocabulary {path}:{line_no}: descriptor byte out of "
                    f"[0, 255]"
                )
            num_nodes += 1
        if num_nodes == 0:
            raise ValueError(f"vocabulary {path}: header but no nodes")

    return VocabularyInfo(k, levels, scoring, weighting, num_nodes)
