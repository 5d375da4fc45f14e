"""Dataset loaders: KITTI odometry, EuRoC MAV, TUM RGB-D, plain image dirs.

JAX replacement for the reference's `FrameSequence`
(`/root/reference/include/frame_sequence.h:25-38` — reads
"<location><next_id+1>.png" grayscale each tick and silently stops on a
missing file; `rename.sh` renames arbitrary dirs to 1..N.png). Each
loader yields grayscale float32 frames plus calibration, and ground-truth
poses when the dataset provides them (for ATE/RPE evaluation).

Decoding is host-side: PNG/PGM through viso_tpu.data.native (C++ decoder,
also behind the prefetch ring), other formats through cv2.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from viso_tpu.geometry import camera


@dataclass
class Frame:
    index: int
    image: np.ndarray                 # (H, W) float32 grayscale
    image_right: Optional[np.ndarray] = None
    timestamp: float = 0.0


@dataclass
class Sequence:
    frames: "object"                  # iterator of Frame
    intrinsics: camera.Intrinsics
    baseline: float = 0.0             # stereo baseline (m), 0 = monocular
    gt_R: Optional[np.ndarray] = None  # (N, 3, 3) world->cam
    gt_t: Optional[np.ndarray] = None
    name: str = ""


def _imread_gray(path):
    """(H, W) float32 grayscale, or None when the file is missing or
    unreadable (readers skip such frames).

    PNG and PGM go through the native C++ decoder only (no OpenCV on the
    main path); other formats (JPEG etc.) need cv2.
    """
    from viso_tpu.data import native

    if path.endswith((".png", ".pgm")):
        native.require()
        return native.decode_gray(path)
    import cv2

    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        return None
    return img.astype(np.float32)


def load_image_dir(location: str, start: int = 1) -> Iterator[Frame]:
    """The reference's exact protocol: <location><n>.png for n = start..
    (frame_sequence.h:28-30), silently ending on the first missing file."""
    n = start
    while True:
        img = _imread_gray(os.path.join(location, f"{n}.png"))
        if img is None:
            return
        yield Frame(index=n - start, image=img)
        n += 1


# ---------------------------------------------------------------------------
# KITTI odometry
# ---------------------------------------------------------------------------

def _kitti_calib(seq_dir):
    """Parse calib.txt -> (Intrinsics, baseline) from P0/P1.

    Tolerates the quirks of real KITTI headers — CRLF line endings,
    comment lines, extra cameras (P2/P3) and the `Tr:` velodyne row —
    and fails LOUDLY (ValueError naming the file) on anything malformed
    instead of crashing downstream with a cryptic shape error.
    """
    path = os.path.join(seq_dir, "calib.txt")
    P = {}
    with open(path, newline="") as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()  # handles \r\n and stray whitespace
            if not line or line.startswith("#"):
                continue
            if ":" not in line:
                raise ValueError(
                    f"{path}:{lineno}: expected 'KEY: v0 v1 ...', got {line!r}"
                )
            key, vals = line.split(":", 1)
            key = key.strip()
            try:
                arr = np.array([float(v) for v in vals.split()], np.float64)
            except ValueError as e:
                raise ValueError(f"{path}:{lineno}: non-numeric value ({e})")
            if key.startswith("P"):
                if arr.size != 12:
                    raise ValueError(
                        f"{path}:{lineno}: {key} needs 12 values, got {arr.size}"
                    )
                P[key] = arr.reshape(3, 4)
            # Tr / R0_rect etc. are valid but unused here.
    P0 = P.get("P0")
    if P0 is None:
        raise ValueError(f"{path}: no P0 projection matrix found")
    P1 = P.get("P1")
    fx, fy, cx, cy = P0[0, 0], P0[1, 1], P0[0, 2], P0[1, 2]
    if fx <= 0 or fy <= 0:
        raise ValueError(f"{path}: non-positive focal length in P0: {fx}, {fy}")
    baseline = -P1[0, 3] / P1[0, 0] if P1 is not None else 0.0
    return camera.Intrinsics.create(fx, fy, cx, cy), float(baseline)


def _kitti_poses(poses_file):
    """KITTI poses.txt rows are cam->world [R|t]; convert to world->cam."""
    data = np.loadtxt(poses_file).reshape(-1, 3, 4)
    R_wc = data[:, :, :3]   # cam->world rotation
    c = data[:, :, 3]       # camera center in world
    R = np.transpose(R_wc, (0, 2, 1))
    t = -np.einsum("nij,nj->ni", R, c)
    return R.astype(np.float32), t.astype(np.float32)


def load_kitti(
    root: str, sequence: str = "00", stereo: bool = True, max_frames=None
) -> Sequence:
    """KITTI odometry: root/sequences/<seq>/image_0|image_1/*.png.

    Ground truth from root/poses/<seq>.txt when present.
    """
    seq_dir = os.path.join(root, "sequences", sequence)
    intr, baseline = _kitti_calib(seq_dir)
    poses_file = os.path.join(root, "poses", f"{sequence}.txt")
    gt_R = gt_t = None
    if os.path.exists(poses_file):
        gt_R, gt_t = _kitti_poses(poses_file)

    def frames():
        i = 0
        while max_frames is None or i < max_frames:
            left = _imread_gray(
                os.path.join(seq_dir, "image_0", f"{i:06d}.png")
            )
            if left is None:
                return
            right = None
            if stereo:
                right = _imread_gray(
                    os.path.join(seq_dir, "image_1", f"{i:06d}.png")
                )
            yield Frame(index=i, image=left, image_right=right, timestamp=0.1 * i)
            i += 1

    return Sequence(
        frames=frames(),
        intrinsics=intr,
        baseline=baseline if stereo else 0.0,
        gt_R=gt_R,
        gt_t=gt_t,
        name=f"kitti-{sequence}",
    )


# ---------------------------------------------------------------------------
# TUM RGB-D
# ---------------------------------------------------------------------------

TUM_FREIBURG1 = dict(fx=517.3, fy=516.5, cx=325.1, cy=249.7)  # ref main.cpp:14-17
TUM_FREIBURG2 = dict(fx=520.9, fy=521.0, cx=325.1, cy=249.7)
TUM_FREIBURG3 = dict(fx=535.4, fy=539.2, cx=320.1, cy=247.6)


def load_tum(root: str, calib=None, max_frames=None) -> Sequence:
    """TUM RGB-D: root/rgb.txt lists 'timestamp rgb/<ts>.png'.

    Default calibration is the freiburg1 set the reference hard-codes
    (main.cpp:14-17).
    """
    calib = calib or TUM_FREIBURG1
    intr = camera.Intrinsics.create(**calib)
    rgb_list = os.path.join(root, "rgb.txt")
    entries = []
    with open(rgb_list) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ts, rel = line.split()[:2]
            entries.append((float(ts), os.path.join(root, rel)))
    if max_frames is not None:
        entries = entries[:max_frames]

    def frames():
        for i, (ts, path) in enumerate(entries):
            img = _imread_gray(path)
            if img is None:
                continue
            yield Frame(index=i, image=img, timestamp=ts)

    gt_R = gt_t = None
    gt_file = os.path.join(root, "groundtruth.txt")
    if os.path.exists(gt_file):
        gt_R, gt_t = _tum_groundtruth(gt_file, [e[0] for e in entries])
    return Sequence(
        frames=frames(), intrinsics=intr, gt_R=gt_R, gt_t=gt_t, name="tum"
    )


def _tum_groundtruth(path, timestamps):
    """Interpolate TUM groundtruth (tx ty tz qx qy qz qw, cam->world)."""
    from scipy.spatial.transform import Rotation, Slerp

    data = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.split()]
            data.append(vals)
    data = np.array(data)
    ts = data[:, 0]
    pos = data[:, 1:4]
    quat = data[:, 4:8]
    rot = Rotation.from_quat(quat)
    slerp = Slerp(ts, rot)
    t_query = np.clip(np.asarray(timestamps), ts[0], ts[-1])
    R_wc = slerp(t_query).as_matrix()
    c = np.stack(
        [np.interp(t_query, ts, pos[:, k]) for k in range(3)], axis=-1
    )
    R = np.transpose(R_wc, (0, 2, 1))
    t = -np.einsum("nij,nj->ni", R, c)
    return R.astype(np.float32), t.astype(np.float32)


# ---------------------------------------------------------------------------
# EuRoC MAV
# ---------------------------------------------------------------------------

EUROC_CAM0 = dict(fx=458.654, fy=457.296, cx=367.215, cy=248.375)


def _euroc_sensor_yaml(path):
    """Parse a real EuRoC mav0/camX/sensor.yaml -> intrinsics dict.

    Real files carry comments, an opencv-matrix block for T_BS, and
    rate/resolution/distortion fields; only `intrinsics: [fx, fy, cx, cy]`
    is needed here. Fails loudly (ValueError naming the file) when the
    field is missing or malformed.
    """
    return _euroc_cam_conf(path)[0]


def _euroc_cam_conf(path):
    """Full EuRoC camX/sensor.yaml parse:
    (intrinsics dict, distortion (4,) radtan, T_BS (4,4) sensor->body,
    resolution (w, h) or None)."""
    import yaml

    with open(path, newline="") as f:
        try:
            doc = yaml.safe_load(f)
        except yaml.YAMLError as e:
            raise ValueError(f"{path}: invalid YAML ({e})")
    if not isinstance(doc, dict) or "intrinsics" not in doc:
        raise ValueError(f"{path}: no `intrinsics` field")
    vals = doc["intrinsics"]
    if not isinstance(vals, (list, tuple)) or len(vals) != 4:
        raise ValueError(
            f"{path}: `intrinsics` must be [fx, fy, cx, cy], got {vals!r}"
        )
    fx, fy, cx, cy = (float(v) for v in vals)
    if fx <= 0 or fy <= 0:
        raise ValueError(f"{path}: non-positive focal length {fx}, {fy}")
    dist = np.zeros(4, np.float64)
    dc = doc.get("distortion_coefficients")
    if isinstance(dc, (list, tuple)) and len(dc) >= 4:
        dist = np.asarray([float(v) for v in dc[:4]], np.float64)
    T_BS = np.eye(4)
    tbs = doc.get("T_BS")
    if isinstance(tbs, dict) and "data" in tbs:
        data = np.asarray([float(v) for v in tbs["data"]], np.float64)
        if data.size != 16:
            raise ValueError(f"{path}: T_BS data must have 16 values")
        T_BS = data.reshape(4, 4)
    res = doc.get("resolution")
    size = None
    if isinstance(res, (list, tuple)) and len(res) == 2:
        size = (int(res[0]), int(res[1]))   # (width, height)
    return dict(fx=fx, fy=fy, cx=cx, cy=cy), dist, T_BS, size


def _euroc_groundtruth(gt_csv, timestamps, T_BS_cam):
    """Interpolated world->cam ground truth from
    state_groundtruth_estimate0/data.csv.

    CSV columns: timestamp[ns], p_RS_R_{x,y,z}, q_RS_{w,x,y,z}, ...
    (quaternion is W-FIRST — scipy wants xyzw). Rows give the BODY pose
    T_WB; the camera pose is T_WC = T_WB @ T_BS (T_BS maps sensor
    coords to body coords, per the ASL convention).
    """
    from scipy.spatial.transform import Rotation, Slerp

    data = []
    with open(gt_csv) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.split(",")[:8]]
            if len(vals) < 8:
                raise ValueError(f"{gt_csv}: row with <8 columns: {line!r}")
            data.append(vals)
    if not data:
        raise ValueError(f"{gt_csv}: no ground-truth rows")
    data = np.asarray(data)
    ts = data[:, 0] * 1e-9
    pos = data[:, 1:4]
    quat_wxyz = data[:, 4:8]
    quat_xyzw = quat_wxyz[:, [1, 2, 3, 0]]
    rot = Rotation.from_quat(quat_xyzw)
    slerp = Slerp(ts, rot)
    t_query = np.clip(np.asarray(timestamps), ts[0], ts[-1])
    R_WB = slerp(t_query).as_matrix()
    p_WB = np.stack(
        [np.interp(t_query, ts, pos[:, k]) for k in range(3)], axis=-1
    )
    # T_WC = T_WB @ T_BS; world->cam = T_WC^-1.
    R_WC = np.einsum("nij,jk->nik", R_WB, T_BS_cam[:3, :3])
    c = np.einsum("nij,j->ni", R_WB, T_BS_cam[:3, 3]) + p_WB
    R = np.transpose(R_WC, (0, 2, 1))
    t = -np.einsum("nij,nj->ni", R, c)
    return R.astype(np.float32), t.astype(np.float32)


def load_euroc(
    root: str, calib=None, max_frames=None, stereo: bool = False
) -> Sequence:
    """EuRoC ASL layout: root/mav0/cam0/data/<ts>.png + data.csv.

    Calibration comes from mav0/cam0/sensor.yaml when present (the real
    dataset always ships it); `calib` overrides, and the published cam0
    values are the last resort.

    stereo=True additionally loads cam1 and RECTIFIES both views with
    the T_BS extrinsics from the two sensor.yaml files (EuRoC's cameras
    are not row-aligned — the stereo matcher scans horizontal epipolar
    lines, so rectification is mandatory, cv2.stereoRectify + remap).
    The returned intrinsics/baseline are the RECTIFIED ones, and ground
    truth is rotated into the rectified cam0 frame.

    Ground truth (mav0/state_groundtruth_estimate0/data.csv, body poses)
    is interpolated to the image timestamps like the TUM path and
    composed with cam0's T_BS, so `--dataset euroc` yields ATE/RPE
    (BASELINE.json config 5 names EuRoC).
    """
    cam0_yaml = os.path.join(root, "mav0", "cam0", "sensor.yaml")
    have_yaml = os.path.exists(cam0_yaml)
    if have_yaml:
        calib0, dist0, T_BS0, size0 = _euroc_cam_conf(cam0_yaml)
    else:
        calib0, dist0, T_BS0, size0 = EUROC_CAM0, np.zeros(4), np.eye(4), None
    if calib is not None:
        calib0 = calib
    cam_dir = os.path.join(root, "mav0", "cam0")
    csv = os.path.join(cam_dir, "data.csv")
    entries = []
    with open(csv) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ts, fname = line.split(",")[:2]
            entries.append((int(ts) * 1e-9, fname.strip()))
    if max_frames is not None:
        entries = entries[:max_frames]

    intr = camera.Intrinsics.create(**calib0)
    baseline = 0.0
    rect = None   # (map0, map1, R_rect0) when stereo
    cam1_dir = os.path.join(root, "mav0", "cam1")
    if stereo:
        import cv2

        cam1_yaml = os.path.join(cam1_dir, "sensor.yaml")
        if not os.path.exists(cam1_yaml):
            raise ValueError(
                f"stereo=True but {cam1_yaml} is missing (cam1 required)"
            )
        calib1, dist1, T_BS1, size1 = _euroc_cam_conf(cam1_yaml)
        if size0 is None:
            first = _imread_gray(
                os.path.join(cam_dir, "data", entries[0][1])
            )
            if first is None:
                raise ValueError(f"{cam_dir}: cannot read first image")
            size0 = (first.shape[1], first.shape[0])
        K0 = np.array(
            [[calib0["fx"], 0, calib0["cx"]],
             [0, calib0["fy"], calib0["cy"]], [0, 0, 1]]
        )
        K1 = np.array(
            [[calib1["fx"], 0, calib1["cx"]],
             [0, calib1["fy"], calib1["cy"]], [0, 0, 1]]
        )
        # T_C1_C0 = T_BS1^-1 @ T_BS0 (both map sensor->body).
        T_10 = np.linalg.inv(T_BS1) @ T_BS0
        R_10, t_10 = T_10[:3, :3], T_10[:3, 3]
        R1, R2, P1, P2, _, _, _ = cv2.stereoRectify(
            K0, dist0, K1, dist1, size0, R_10, t_10.reshape(3, 1),
            flags=cv2.CALIB_ZERO_DISPARITY, alpha=0,
        )
        m0 = cv2.initUndistortRectifyMap(
            K0, dist0, R1, P1, size0, cv2.CV_32FC1
        )
        m1 = cv2.initUndistortRectifyMap(
            K1, dist1, R2, P2, size0, cv2.CV_32FC1
        )
        rect = (m0, m1, R1)
        intr = camera.Intrinsics.create(
            P1[0, 0], P1[1, 1], P1[0, 2], P1[1, 2]
        )
        baseline = float(-P2[0, 3] / P2[0, 0])

    def frames():
        for i, (ts, fname) in enumerate(entries):
            img = _imread_gray(os.path.join(cam_dir, "data", fname))
            if img is None:
                continue
            right = None
            if stereo:
                right = _imread_gray(os.path.join(cam1_dir, "data", fname))
                if right is None:
                    continue   # stereo needs the pair; skip odd frames
                import cv2

                img = cv2.remap(img, *rect[0], cv2.INTER_LINEAR)
                right = cv2.remap(right, *rect[1], cv2.INTER_LINEAR)
            yield Frame(index=i, image=img, image_right=right, timestamp=ts)

    gt_R = gt_t = None
    gt_csv = os.path.join(
        root, "mav0", "state_groundtruth_estimate0", "data.csv"
    )
    if os.path.exists(gt_csv):
        gt_R, gt_t = _euroc_groundtruth(
            gt_csv, [e[0] for e in entries], T_BS0
        )
        if rect is not None:
            # Rotate GT into the rectified cam0 frame:
            # T_rect = [R1|0] o T_cam0 (left rotation-only).
            R1 = rect[2]
            gt_t = np.einsum("ij,nj->ni", R1, gt_t).astype(np.float32)
            gt_R = np.einsum("ij,njk->nik", R1, gt_R).astype(np.float32)

    return Sequence(
        frames=frames(), intrinsics=intr, baseline=baseline,
        gt_R=gt_R, gt_t=gt_t, name="euroc",
    )
