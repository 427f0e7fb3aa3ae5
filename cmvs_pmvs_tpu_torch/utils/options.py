"""PMVS option files and derived reconstruction thresholds.

Replicates the reference option grammar and defaults
(reference: source/pmvs/option.cpp:10-28 for defaults, :30-158 for the
parser, :160-299 for oimages/visdata expansion) plus the derived threshold
set the engine uses (reference: source/pmvs/findMatch.cpp:30-107).

The port's own copy of cmvs_pmvs_tpu/utils/options.py
(the port imports nothing of the JAX package).
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass, field, replace


@dataclass
class PMVSOptions:
    """Parsed contents of a PMVS option file.

    Field defaults follow reference source/pmvs/option.cpp:10-28.
    `timages`/`oimages` hold *image ids* (not indexes), with `tflag`/`oflag`
    recording the raw specification mode:
      tflag  > 0 : enumeration;  -1 : [first, last) range
      oflag >= 0 : enumeration;  -1 : range; -2 : derive from vis.dat;
                   -3 : none
    """

    level: int = 1
    csize: int = 2
    threshold: float = 0.7
    wsize: int = 7
    min_image_num: int = 3
    cpu: int = 4
    set_edge: float = 0.0
    use_bound: int = 0
    use_vis_data: int = 0
    sequence: int = -1
    tflag: int = -10
    oflag: int = -10
    timages: list[int] = field(default_factory=list)
    oimages: list[int] = field(default_factory=list)
    # Degrees converted to radians at parse time (option.cpp:104-106)
    max_angle_threshold: float = 10.0 * math.pi / 180.0
    quad_threshold: float = 2.5
    prefix: str = ""   # directory of the option file (for bimages.dat)

    @classmethod
    def parse(cls, path: str) -> "PMVSOptions":
        """Parse a PMVS option file (reference option.cpp:30-116).

        Grammar: whitespace-separated `key value...` tokens; `#` starts a
        comment running to end of line; unknown keys are an error.
        """
        import os as _os
        opt = cls()
        opt.prefix = _os.path.dirname(_os.path.abspath(path))
        with open(path) as f:
            text = f.read()
        tokens = _tokenize(text)
        i = 0
        simple = {
            "level": ("level", int),
            "csize": ("csize", int),
            "threshold": ("threshold", float),
            "wsize": ("wsize", int),
            "minImageNum": ("min_image_num", int),
            "CPU": ("cpu", int),
            "setEdge": ("set_edge", float),
            "useBound": ("use_bound", int),
            "useVisData": ("use_vis_data", int),
            "sequence": ("sequence", int),
            "quad": ("quad_threshold", float),
        }
        while i < len(tokens):
            name = tokens[i]
            i += 1
            if name in simple:
                attr, typ = simple[name]
                setattr(opt, attr, typ(tokens[i]))
                i += 1
            elif name == "maxAngle":
                opt.max_angle_threshold = float(tokens[i]) * math.pi / 180.0
                i += 1
            elif name == "timages":
                opt.tflag = int(tokens[i]); i += 1
                if opt.tflag == -1:
                    first, last = int(tokens[i]), int(tokens[i + 1]); i += 2
                    opt.timages = list(range(first, last))
                elif opt.tflag > 0:
                    opt.timages = [int(t) for t in tokens[i:i + opt.tflag]]
                    i += opt.tflag
                else:
                    raise ValueError(f"tflag is not valid: {opt.tflag}")
            elif name == "oimages":
                opt.oflag = int(tokens[i]); i += 1
                if opt.oflag == -1:
                    first, last = int(tokens[i]), int(tokens[i + 1]); i += 2
                    opt.oimages = list(range(first, last))
                elif opt.oflag >= 0:
                    opt.oimages = [int(t) for t in tokens[i:i + opt.oflag]]
                    i += opt.oflag
                elif opt.oflag not in (-2, -3):
                    raise ValueError(f"oflag is not valid: {opt.oflag}")
            else:
                raise ValueError(f"Unrecognizable option: {name}")
        if opt.tflag == -10 or opt.oflag == -10:
            raise ValueError(
                f"tflag and oflag not specified: {opt.tflag} {opt.oflag}")
        return opt

    def write(self, path: str, comment: str = "") -> None:
        """Serialize in the genOption layout (reference genOption.cpp:76-108)."""
        lines = []
        if comment:
            lines.append(f"# {comment}")
        lines += [
            f"level {self.level}",
            f"csize {self.csize}",
            f"threshold {self.threshold}",
            f"wsize {self.wsize}",
            f"minImageNum {self.min_image_num}",
            f"CPU {self.cpu}",
            f"setEdge {self.set_edge}",
            f"useBound {self.use_bound}",
            f"useVisData {self.use_vis_data}",
            f"sequence {self.sequence}",
            f"maxAngle {self.max_angle_threshold * 180.0 / math.pi}",
            f"quad {self.quad_threshold}",
            "timages " + str(len(self.timages)) + " "
            + " ".join(str(t) for t in self.timages),
            "oimages " + str(len(self.oimages)) + " "
            + " ".join(str(t) for t in self.oimages),
        ]
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")

    def resolve_oimages(self, prefix: str) -> "PMVSOptions":
        """Expand oflag==-2 into image ids read from vis.dat
        (reference option.cpp:160-199)."""
        if self.oflag != -2:
            return self
        from ..io.visdata import read_vis
        vis = read_vis(os.path.join(prefix, "vis.dat"))
        tset = set(self.timages)
        oset: set[int] = set()
        for c, neigh in enumerate(vis):
            if c not in tset:
                continue
            for n in neigh:
                if n not in tset:
                    oset.add(n)
        return replace(self, oimages=sorted(oset))


def _tokenize(text: str) -> list[str]:
    """Whitespace tokens with #-to-EOL comments stripped
    (reference option.cpp:41-46)."""
    out: list[str] = []
    for line in text.splitlines():
        for tok in line.split():
            if tok.startswith("#"):
                break
            out.append(tok)
        else:
            continue
    return out


def build_visdata(opt: PMVSOptions, prefix: str) -> list[list[int]]:
    """Per-image candidate-view adjacency over engine indexes.

    Mirrors SOption::initVisdata/initVisdata2 (reference option.cpp:202-299):
    with use_vis_data==0, all-to-all minus self; otherwise read vis.dat,
    remap image ids -> engine indexes (timages then oimages), drop unknown
    ids, and enforce symmetry.
    """
    images = list(opt.timages) + list(opt.oimages)
    num = len(images)
    if opt.use_vis_data == 0:
        return [[x for x in range(num) if x != y] for y in range(num)]

    from ..io.visdata import read_vis
    vis = read_vis(os.path.join(prefix, "vis.dat"))
    dict2 = {img: i for i, img in enumerate(images)}
    mat = [[0] * num for _ in range(num)]
    for c, neigh in enumerate(vis):
        i0 = dict2.get(c, -1)
        if i0 == -1:
            continue
        for n in neigh:
            i1 = dict2.get(n, -1)
            if i1 != -1:
                mat[i0][i1] = 1
    # symmetry (option.cpp:292-298)
    for i in range(num):
        for j in range(i + 1, num):
            if mat[i][j] != mat[j][i]:
                mat[i][j] = mat[j][i] = 1
    return [[x for x in range(num) if mat[y][x]] for y in range(num)]


def read_bimages(prefix: str, image_ids) -> tuple:
    """Read bimages.dat and map on-disk ids to engine indices
    (reference option.cpp:301-324 initBindexes: "count, then ids";
    ids missing from the image dictionary are skipped)."""
    import os
    path = os.path.join(prefix, "bimages.dat")
    if not os.path.exists(path):
        raise FileNotFoundError(f"useBound set but {path} not found")
    with open(path) as f:
        tok = f.read().split()
    count = int(tok[0])
    dict_ = {img_id: k for k, img_id in enumerate(image_ids)}
    out = []
    for t in tok[1:1 + count]:
        i = int(t)
        if i in dict_:
            out.append(dict_[i])
    return tuple(out)
