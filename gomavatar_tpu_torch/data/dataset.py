"""Datasets: monocular train, ZJU multi-view test, freeview orbit, MDM
novel pose (port of gomavatar_tpu/data/dataset.py).

Host-side numpy pipelines: items are plain numpy dicts with the reference's
key set, equal to the JAX package's item for item under the same rng seed;
``to_device`` turns one into float32 tensors on the device, and the thread
``Prefetcher`` overlaps host decode with the device's step.  A train item
of a frame kept on the card holds its target image and mask there
(``CardArray``), composited and resized by the card (``data/composite.py``).

The artifact format is the reference's preprocessed directory (images/*.png,
masks/*.png, cameras.pkl, mesh_infos.pkl, canonical_joints.pkl).
"""

from __future__ import annotations

import os
import pickle
import queue
import threading

import numpy as np

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None

import torch

from gomavatar_tpu_torch.data.composite import composite_resize
from gomavatar_tpu_torch.ops.camera import (
    apply_global_tfm_to_camera,
    rotate_camera_by_frame_idx,
)
from gomavatar_tpu_torch.ops.skeleton import SMPL_PARENT
from gomavatar_tpu_torch.utils.profiling import count, span


# numpy versions of pose -> RTs (host side; the tensor versions live in ops.skeleton)

def _np_rodrigues(rvec):
    theta = np.linalg.norm(rvec)
    if theta < 1e-10:
        return np.eye(3, dtype=np.float32)
    k = rvec / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return (np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)).astype(np.float32)


def body_pose_to_body_RTs_np(jangles, tpose_joints):
    jangles = np.asarray(jangles, np.float32).reshape(-1, 3)
    J = jangles.shape[0]
    Rs = np.stack([_np_rodrigues(jangles[i]) for i in range(J)])
    Ts = tpose_joints - tpose_joints[SMPL_PARENT[:J]]
    Ts[0] = tpose_joints[0]
    return Rs.astype(np.float32), Ts.astype(np.float32)


def get_canonical_global_tfms_np(joints):
    J = joints.shape[0]
    G = np.tile(np.eye(4, dtype=np.float32), (J, 1, 1))
    G[:, :3, 3] = joints
    return G


def get_joints_from_pose_np(pose, tpose_joints):
    Rs, Ts = body_pose_to_body_RTs_np(pose, tpose_joints)
    G = np.zeros((len(Rs), 4, 4), np.float32)
    G[0, :3, :3] = Rs[0]
    G[0, :3, 3] = Ts[0]
    G[0, 3, 3] = 1
    for i in range(1, len(Rs)):
        L = np.eye(4, dtype=np.float32)
        L[:3, :3] = Rs[i]
        L[:3, 3] = Ts[i]
        G[i] = G[SMPL_PARENT[i]] @ L
    return G[:, :3, 3]


def _load_image(path):
    from PIL import Image

    return np.array(Image.open(path))


def _available_memory_bytes() -> int:
    """The host's available physical memory now."""
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


class CardArray:
    """A float32 array that an item holds on the card: the output of a
    launch on the dataset's stream, complete once ``event`` has passed.
    ``np.asarray`` gives its host copy, after the launch; ``to_device``
    hands the tensor itself to the consuming stream (:meth:`on`)."""

    def __init__(self, tensor: torch.Tensor, event):
        self.tensor, self.event = tensor, event

    def __array__(self, dtype=None, copy=None):
        if self.event is not None:
            self.event.synchronize()
        a = self.tensor.cpu().numpy()
        return a if dtype is None else a.astype(dtype, copy=False)

    def on(self, device) -> torch.Tensor:
        """The array on ``device``: on its own card the tensor, which the
        current stream takes after the launch (and holds until it is done
        with it), elsewhere a copy."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device == self.tensor.device:
            if self.event is not None:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(self.event)
                self.tensor.record_stream(stream)
            return self.tensor
        return torch.from_numpy(np.asarray(self)).to(device)


class _ThreadSafeRng:
    """Lock-guarded np.random.Generator: the Prefetcher worker pool calls
    ``__getitem__`` from several threads and Generator state updates are not
    thread-safe."""

    def __init__(self, gen):
        self._gen = gen
        self._lock = threading.Lock()

    def random(self, *a, **k):
        with self._lock:
            return self._gen.random(*a, **k)

    def integers(self, *a, **k):
        with self._lock:
            return self._gen.integers(*a, **k)


def _list_frames(image_dir):
    return sorted(
        os.path.splitext(f)[0] for f in os.listdir(image_dir) if f.endswith(".png")
    )


class _ArtifactsMixin:
    """Shared loading of the preprocessed-dir artifacts."""

    BBOX_OFFSET = 0.3

    def _load_artifacts(self, dataset_path):
        self.dataset_path = dataset_path
        self.image_dir = os.path.join(dataset_path, "images")
        with open(os.path.join(dataset_path, "canonical_joints.pkl"), "rb") as f:
            cj = pickle.load(f)
        self.canonical_joints = cj["joints"].astype(np.float32)
        self.canonical_vertex = cj["vertex"].astype(np.float32)
        self.canonical_lbs_weights = cj["weights"].astype(np.float32)
        self.edges = cj.get("edges")
        self.faces = cj.get("faces")
        with open(os.path.join(dataset_path, "cameras.pkl"), "rb") as f:
            self.cameras = pickle.load(f)
        with open(os.path.join(dataset_path, "mesh_infos.pkl"), "rb") as f:
            self.mesh_infos = pickle.load(f)

    def skeleton_to_bbox(self, skeleton):
        return {
            "min_xyz": np.min(skeleton, axis=0) - self.BBOX_OFFSET,
            "max_xyz": np.max(skeleton, axis=0) + self.BBOX_OFFSET,
        }

    def query_dst_skeleton(self, frame_name):
        mi = self.mesh_infos[frame_name]
        return {
            "poses": mi["poses"].astype(np.float32),
            "dst_tpose_joints": mi["tpose_joints"].astype(np.float32),
            "Rh": mi["Rh"].astype(np.float32),
            "Th": mi["Th"].astype(np.float32),
        }

    def get_canonical_info(self):
        bbox = self.skeleton_to_bbox(self.canonical_joints)
        return {
            "canonical_joints": self.canonical_joints,
            "canonical_bbox": {
                "min_xyz": bbox["min_xyz"],
                "max_xyz": bbox["max_xyz"],
                "scale_xyz": bbox["max_xyz"] - bbox["min_xyz"],
            },
            "canonical_vertex": self.canonical_vertex,
            "canonical_lbs_weights": self.canonical_lbs_weights,
            "edges": self.edges,
            "faces": self.faces,
        }

    def _skeleton_outputs(self, dst_poses, dst_tpose_joints):
        dst_Rs, dst_Ts = body_pose_to_body_RTs_np(dst_poses, dst_tpose_joints)
        return {
            "dst_poses": dst_poses,
            "dst_Rs": dst_Rs,
            "dst_Ts": dst_Ts,
            "cnl_gtfms": get_canonical_global_tfms_np(self.canonical_joints),
            "dst_posevec": dst_poses.reshape(-1)[3:] + 1e-2,
        }


class TrainDataset(_ArtifactsMixin):
    """Monocular training frames.

    The store: a frame's undistorted ``uint8`` image and mask (one channel
    where the PNG's are equal), kept after the frame's first read when the
    caller re-reads frames epoch after epoch (``retain=True``, the training
    loop), or read for every frame at construction (``prefetch=True``).
    Each item of a stored frame draws its background and crop anew, so its
    arrays are those of a fresh read bit for bit.  The store is on the card
    of a CUDA ``device`` (a type of ``CARD_TYPES``) where the cv2 path reads
    at a ``target_size`` with no crop, else on the host; its room is half
    that device's free memory at construction.  A frame past it, or on a
    card one whose mask's channels differ, is read each time.  Each item of
    a frame on the card is composited and resized there by one launch on
    the dataset's own stream (``data/composite.py``), bit for bit the
    host's float64 composite and OpenCV resizes, into ``CardArray``s that
    ``to_device`` hands over as they are.  Counters (``utils.profiling``)
    per item of the cv2 path: ``data.decode_cache_hit`` or
    ``data.decode_cache_miss`` (a miss has the ``data.read`` and
    ``data.undistort`` spans, a hit neither), and ``data.device_composite``
    or ``data.host_composite``; the span ``data.composite_resize`` is the
    host's composite, or on the card its launch."""

    # the device types whose store and composite are the device's (the CPU
    # only in tests: its plain version is slower than OpenCV's)
    CARD_TYPES = ("cuda",)

    def __init__(
        self,
        dataset_path,
        maxframes=-1,
        bgcolor=None,
        skip=1,
        target_size=None,
        crop_size=(-1, -1),
        prefetch=False,
        split_for_pose=False,
        rng=None,
        use_native=False,
        retain=False,
        device=None,
    ):
        """``use_native=True`` routes decode through the fused C++ pipeline
        (native/gom_host.cpp: undistort, resize and composite in one
        bilinear pass) instead of the reference-parity cv2 path (undistort,
        composite, Lanczos resize as three passes), which the store does
        not serve.  ``retain=True`` fills the store as frames are first
        read (for a caller that reads each frame many times); ``device``,
        where it is a CUDA device (a type of ``CARD_TYPES``), keeps the
        store on that card."""
        self._load_artifacts(dataset_path)
        self.use_native = use_native
        if use_native:
            from gomavatar_tpu_torch.data import native_loader

            assert native_loader.available(), "native library failed to build"
            self._native = native_loader
        self.framelist = _list_frames(self.image_dir)[::skip]
        if maxframes > 0:
            self.framelist = self.framelist[:maxframes]
        if split_for_pose and len(self.framelist) >= 5:  # MonoHuman split: train on the first 4/5
            self.framelist = self.framelist[: -(len(self.framelist) // 5)]
        self.bgcolor = bgcolor
        self.target_size = target_size
        self.crop_size = tuple(crop_size)
        self.rng = _ThreadSafeRng(rng or np.random.default_rng())
        self.resize_img_scale = (0.5, 0.5)
        self.prefetch = prefetch
        self.retain = retain
        # the store: frame name -> (uint8 image, uint8 mask), tensors on
        # self._card_dev where it is set, else host arrays
        self._store, self._store_bytes, self._store_room = {}, 0, 0
        self._store_lock = threading.Lock()
        self._card_dev = self._card_stream = None
        device = torch.device(device) if device is not None else None
        if (retain or prefetch) and device is not None and device.type in self.CARD_TYPES and not use_native \
                and target_size is not None and self.crop_size == (-1, -1):
            if device.type == "cuda" and device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            self._card_dev = device
        if self._card_dev is not None and device.type == "cuda":
            self._store_room = torch.cuda.mem_get_info(device)[0] // 2
            self._card_stream = torch.cuda.Stream(device)
        elif retain or prefetch:
            self._store_room = _available_memory_bytes() // 2
        if prefetch:
            for fn in self.framelist:
                self._keep(fn, *self._load_raw(fn))

    def __len__(self):
        return len(self.framelist)

    def _load_raw(self, frame_name):
        """The frame's undistorted ``uint8`` image and mask, the mask one
        channel where the PNG's are equal."""
        with span("data.read"):
            img = _load_image(os.path.join(self.image_dir, frame_name + ".png"))
            alpha = _load_image(os.path.join(self.dataset_path, "masks", frame_name + ".png"))
        if alpha.ndim == 3 and (alpha == alpha[..., :1]).all():
            alpha = np.ascontiguousarray(alpha[..., 0])
        cam = self.cameras[frame_name]
        if "distortions" in cam and cv2 is not None:
            K = cam["intrinsics"]
            D = cam["distortions"]
            with span("data.undistort"):
                img = cv2.undistort(img, K, D)
                alpha = cv2.undistort(alpha, K, D)
        return img, alpha

    def _keep(self, frame_name, img, alpha):
        """Store the frame's arrays while the store has room (on a card only
        a one-channel mask); returns what the store keeps, or None."""
        if self._card_dev is not None and img.shape != alpha.shape + (3,):
            return None
        nbytes = img.nbytes + alpha.nbytes
        with self._store_lock:
            if frame_name in self._store or self._store_bytes + nbytes > self._store_room:
                return self._store.get(frame_name)
            if self._card_dev is None:
                img.flags.writeable = alpha.flags.writeable = False
                kept = img, alpha
            else:
                with torch.cuda.stream(self._card_stream):
                    kept = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (img, alpha))
                    if self._card_stream is not None:
                        kept = tuple(t.pin_memory().to(self._card_dev, non_blocking=True) for t in kept)
            self._store[frame_name] = kept
            self._store_bytes += nbytes
        return kept

    def _decoded(self, frame_name):
        """The frame's undistorted ``uint8`` image and mask: from the store
        (on the card its tensors), or read (and stored where the caller
        retains)."""
        kept = self._store.get(frame_name)
        if kept is not None:
            count("data.decode_cache_hit")
            return kept
        count("data.decode_cache_miss")
        img, alpha = self._load_raw(frame_name)
        if self.retain:
            kept = self._keep(frame_name, img, alpha)
        return (img, alpha) if kept is None else kept

    def _composite_on_card(self, img, mask, bgcolor):
        """(target image, target mask) as ``CardArray``s: the composite and
        resizes of the frame on the card, launched on the dataset's
        stream."""
        w, h = self.target_size
        with span("data.composite_resize"), torch.cuda.stream(self._card_stream):
            rgb, m = composite_resize(img, mask, bgcolor, (h, w))
            done = None
            if self._card_stream is not None:
                done = torch.cuda.Event()
                done.record(self._card_stream)
        return CardArray(rgb, done), CardArray(m, done)

    def _composite_resize(self, img, alpha, bgcolor):
        with span("data.composite_resize"):
            a = alpha[..., None] if alpha.ndim == 2 else alpha
            img = a * img + (1.0 - a) * bgcolor[None, None, :]
            if self.target_size is not None:
                w, h = self.target_size
                img = cv2.resize(img, (w, h), interpolation=cv2.INTER_LANCZOS4)
                alpha = cv2.resize(alpha, (w, h), interpolation=cv2.INTER_LINEAR)
            elif self.resize_img_scale != 1.0:
                img = cv2.resize(
                    img, None, fx=self.resize_img_scale[0], fy=self.resize_img_scale[1],
                    interpolation=cv2.INTER_LANCZOS4,
                )
                alpha = cv2.resize(
                    alpha, None, fx=self.resize_img_scale[0], fy=self.resize_img_scale[1],
                    interpolation=cv2.INTER_LINEAR,
                )
        return img, alpha

    def _random_crop(self, img, alpha, K, rng):
        """Random crop around the subject."""
        crop_w, crop_h = self.crop_size
        h, w = img.shape[:2]
        # the window's mass over three channels in their layout: the reference's sum bit for bit
        mass = alpha if alpha.ndim == 3 else np.repeat(alpha[..., None], 3, axis=-1)
        nz = np.stack(np.nonzero(mass[..., 0]), axis=-1)
        h_center, w_center = nz.mean(axis=0).astype(int)
        h_center = int(np.clip(h_center, crop_h // 2, h - (crop_h + 1) // 2))
        w_center = int(np.clip(w_center, crop_w // 2, w - (crop_w + 1) // 2))
        h_left = h_center - crop_h // 2
        w_left = w_center - crop_w // 2
        for _ in range(100):
            rand_w = rng.integers(max(0, w_left - 50), min(w_left + 50, w - crop_w) + 1)
            rand_h = rng.integers(max(0, h_left - 50), min(h_left + 50, h - crop_h) + 1)
            m = mass[rand_h : rand_h + crop_h, rand_w : rand_w + crop_w]
            if np.sum(m) >= 20:
                break
        K_new = K.copy()
        K_new[0, 2] -= rand_w
        K_new[1, 2] -= rand_h
        return (
            img[rand_h : rand_h + crop_h, rand_w : rand_w + crop_w],
            alpha[rand_h : rand_h + crop_h, rand_w : rand_w + crop_w],
            K_new,
        )

    def __getitem__(self, idx):
        return self.item(idx, self.rng)

    def item(self, idx, rng):
        """Frame ``idx`` with its random draws (the background color under
        ``bgcolor=None``, the crop) taken from ``rng``; ``dataset[idx]``
        takes them from the dataset's own stream."""
        frame_name = self.framelist[idx]
        if self.bgcolor is None:
            bgcolor = (rng.random(3) * 255.0).astype(np.float32)
        else:
            bgcolor = np.asarray(self.bgcolor, np.float32)

        if self.use_native:
            img_path = os.path.join(self.image_dir, frame_name + ".png")
            mask_path = os.path.join(self.dataset_path, "masks", frame_name + ".png")
            cam = self.cameras[frame_name]
            if self.target_size is not None:
                out_hw = (self.target_size[1], self.target_size[0])
                orig_H, orig_W = self._native.probe_image(img_path)
            else:
                orig_H, orig_W = self._native.probe_image(img_path)
                out_hw = (
                    int(orig_H * self.resize_img_scale[1]),
                    int(orig_W * self.resize_img_scale[0]),
                )
            with span("data.native_load"):
                img, alpha = self._native.load_frame(
                    img_path, mask_path, cam["intrinsics"][:3, :3],
                    cam.get("distortions"), bgcolor, out_hw,
                )
            img = (img / 255.0).astype(np.float32)
        else:
            img, alpha = self._decoded(frame_name)
            orig_H, orig_W = img.shape[:2]
            if isinstance(img, torch.Tensor):
                count("data.device_composite")
                img, alpha = self._composite_on_card(img, alpha, bgcolor)
            else:
                count("data.host_composite")
                img, alpha = self._composite_resize(img.astype(np.float32), alpha / 255.0, bgcolor)
                img = (img / 255.0).astype(np.float32)

        skel = self.query_dst_skeleton(frame_name)
        K = self.cameras[frame_name]["intrinsics"][:3, :3].copy()
        if self.target_size is not None:
            K[:1] *= self.target_size[0] / orig_W
            K[1:2] *= self.target_size[1] / orig_H
        else:
            K[:1] *= self.resize_img_scale[0]
            K[1:2] *= self.resize_img_scale[1]
        E, global_tfms = apply_global_tfm_to_camera(
            self.cameras[frame_name]["extrinsics"], skel["Rh"], skel["Th"], return_global_tfms=True
        )
        if self.crop_size != (-1, -1):
            img, alpha, K = self._random_crop(img, alpha, K, rng)

        out = {
            "frame_name": frame_name,
            "bgcolor": bgcolor / 255.0,
            "K": K.astype(np.float32),
            "E": E.astype(np.float32),
            "global_tfms": global_tfms.astype(np.float32),
            "target_rgbs": img,
            "target_masks": (alpha if isinstance(alpha, CardArray)
                             else alpha[..., 0].astype(np.float32) if alpha.ndim == 3 else alpha.astype(np.float32)),
        }
        out.update(self._skeleton_outputs(skel["poses"], skel["dst_tpose_joints"]))
        out["joints"] = get_joints_from_pose_np(skel["poses"], skel["dst_tpose_joints"])
        out["dst_tpose_joints"] = skel["dst_tpose_joints"]
        return out

    def get_all_Es(self):
        """All extrinsics with the global transforms folded in."""
        Es = []
        for frame_name in self.framelist:
            skel = self.query_dst_skeleton(frame_name)
            E = apply_global_tfm_to_camera(
                self.cameras[frame_name]["extrinsics"], skel["Rh"], skel["Th"]
            )
            Es.append(E)
        return np.stack(Es)


class ZJUTestDataset(_ArtifactsMixin):
    """Multi-view novel-view / novel-pose eval over the raw ZJU capture,
    with the MonoHuman split (the last fifth of the frames is the pose
    split)."""

    def __init__(
        self,
        raw_dataset_path,
        dataset_path,
        test_type="view",
        bgcolor=None,
        exclude_view=0,
        skip=30,
        rng=None,
    ):
        self._load_artifacts(dataset_path)
        self.raw_dataset_path = raw_dataset_path
        self.bgcolor = bgcolor
        self.rng = _ThreadSafeRng(rng or np.random.default_rng())
        self.resize_img_scale = 0.5
        self.test_cameras = self._load_raw_cameras(exclude_view)

        framelist = _list_frames(self.image_dir)
        fifth = len(framelist) // 5  # MonoHuman split
        if test_type == "view":
            framelist = framelist[:-fifth] if fifth > 0 else framelist
        elif test_type == "pose":
            framelist = framelist[-fifth:] if fifth > 0 else []
        else:
            raise ValueError(test_type)
        self.framelist = framelist[::skip]

    def _load_raw_cameras(self, exclude_view):
        annots = np.load(
            os.path.join(self.raw_dataset_path, "annots.npy"), allow_pickle=True
        ).item()
        cams = annots["cams"]
        out = {}
        for view_id in range(len(cams["K"])):
            if view_id == exclude_view:
                continue
            K = np.array(cams["K"])[view_id].astype(np.float32)
            R = np.array(cams["R"])[view_id].astype(np.float32)
            T = np.array(cams["T"])[view_id].astype(np.float32) / 1000.0
            D = np.array(cams["D"])[view_id].astype(np.float32)[:, 0]
            E = np.eye(4, dtype=np.float32)
            E[:3, :3] = R
            E[:3, 3] = T[:3, 0]
            out[view_id] = {"intrinsics": K, "extrinsics": E, "distortions": D}
        return out

    def __len__(self):
        return len(self.framelist) * len(self.test_cameras)

    def _load_view_image(self, view_id, frame_id, bgcolor):
        cam_dir = f"Camera_B{view_id + 1}"
        img = _load_image(
            os.path.join(self.raw_dataset_path, cam_dir, f"{frame_id:06d}.jpg")
        )
        m1 = _load_image(
            os.path.join(self.raw_dataset_path, "mask", cam_dir, f"{frame_id:06d}.png")
        )
        m2 = _load_image(
            os.path.join(self.raw_dataset_path, "mask_cihp", cam_dir, f"{frame_id:06d}.png")
        )
        if m1.ndim == 3:
            m1 = m1[..., 0]
        if m2.ndim == 3:
            m2 = m2[..., 0]
        mask = (((m1 != 0) | (m2 != 0)).astype(np.float32))[..., None]
        cam = self.test_cameras[view_id]
        if cv2 is not None:
            img = cv2.undistort(img, cam["intrinsics"], cam["distortions"])
            mask = cv2.undistort(mask, cam["intrinsics"], cam["distortions"])[..., None]
        img = mask * img + (1 - mask) * bgcolor[None, None, :]
        s = self.resize_img_scale
        img = cv2.resize(img, None, fx=s, fy=s, interpolation=cv2.INTER_LANCZOS4)
        mask = cv2.resize(mask, None, fx=s, fy=s, interpolation=cv2.INTER_LINEAR)
        return img, mask

    def __getitem__(self, idx):
        view_id = sorted(self.test_cameras.keys())[idx % len(self.test_cameras)]
        frame_name = self.framelist[idx // len(self.test_cameras)]
        frame_id = int(frame_name.split("_")[1])

        if self.bgcolor is None:
            bgcolor = (self.rng.random(3) * 255.0).astype(np.float32)
        else:
            bgcolor = np.asarray(self.bgcolor, np.float32)
        img, mask = self._load_view_image(view_id, frame_id, bgcolor)
        img = (img / 255.0).astype(np.float32)

        skel = self.query_dst_skeleton(frame_name)
        K = self.test_cameras[view_id]["intrinsics"][:3, :3].copy()
        K[:2] *= self.resize_img_scale
        E = apply_global_tfm_to_camera(
            self.test_cameras[view_id]["extrinsics"], skel["Rh"], skel["Th"]
        )
        out = {
            "frame_name": f"Camera_B{view_id + 1}_{frame_name}",
            "bgcolor": bgcolor / 255.0,
            "K": K.astype(np.float32),
            "E": E.astype(np.float32),
            "target_rgbs": img,
            "target_masks": mask.astype(np.float32),
        }
        out.update(self._skeleton_outputs(skel["poses"], skel["dst_tpose_joints"]))
        return out


class FreeviewDataset(_ArtifactsMixin):
    """360-degree orbit around one training frame, about the source type's
    axis."""

    ROT_CAM_PARAMS = {
        "zju_mocap": {"rotate_axis": "z", "inv_angle": True},
        "wild": {"rotate_axis": "y", "inv_angle": False},
    }

    def __init__(
        self,
        dataset_path,
        frame_idx=0,
        total_frames=100,
        bgcolor=(0.0, 0.0, 0.0),
        src_type="zju_mocap",
        target_size=None,
    ):
        self._load_artifacts(dataset_path)
        framelist = _list_frames(self.image_dir)
        self.train_frame_name = framelist[frame_idx]
        self.train_camera = self.cameras[self.train_frame_name]
        self.train_mesh_info = self.mesh_infos[self.train_frame_name]
        self.total_frames = total_frames
        self.bgcolor = np.asarray(bgcolor, np.float32)
        self.src_type = src_type
        self.target_size = target_size
        self.resize_img_scale = (0.5, 0.5)
        # probe the training image shape ONCE (items only need H, W)
        img = _load_image(os.path.join(self.image_dir, self.train_frame_name + ".png"))
        self.train_img_shape = img.shape[:2]

    def __len__(self):
        return self.total_frames

    def __getitem__(self, idx):
        skel = {
            "poses": self.train_mesh_info["poses"].astype(np.float32),
            "dst_tpose_joints": self.train_mesh_info["tpose_joints"].astype(np.float32),
            "Rh": self.train_mesh_info["Rh"].astype(np.float32),
            "Th": self.train_mesh_info["Th"].astype(np.float32),
        }
        E0 = apply_global_tfm_to_camera(
            self.train_camera["extrinsics"], skel["Rh"], skel["Th"]
        )
        joints = get_joints_from_pose_np(skel["poses"], skel["dst_tpose_joints"])
        E = rotate_camera_by_frame_idx(
            E0,
            idx,
            period=self.total_frames,
            trans=joints.mean(axis=0),
            **self.ROT_CAM_PARAMS[self.src_type],
        )
        K = self.train_camera["intrinsics"][:3, :3].copy()
        img_h, img_w = self.train_img_shape
        if self.target_size is not None:
            # scale K from the original image size to target
            K[:1] *= self.target_size[0] / img_w
            K[1:2] *= self.target_size[1] / img_h
            H, W = self.target_size[1], self.target_size[0]
        else:
            K[:2] *= self.resize_img_scale[0]
            H = int(img_h * self.resize_img_scale[1])
            W = int(img_w * self.resize_img_scale[0])

        out = {
            "frame_name": f"{self.train_frame_name}_v{idx:04d}",
            "bgcolor": self.bgcolor / 255.0,
            "K": K.astype(np.float32),
            "E": E.astype(np.float32),
            "target_rgbs": np.zeros((H, W, 3), np.float32),
            "target_masks": np.zeros((H, W), np.float32),
        }
        out.update(self._skeleton_outputs(skel["poses"], skel["dst_tpose_joints"]))
        return out


class NewPoseDataset(_ArtifactsMixin):
    """MDM-driven novel-pose animation with a synthetic camera (radius 8,
    focal 1250, 512x512) and zeroed targets."""

    def __init__(
        self,
        dataset_path,
        pose_path,
        bgcolor=(0.0, 0.0, 0.0),
        img_size=(512, 512),
        radius=8.0,
        focal=1250.0,
    ):
        self._load_artifacts(dataset_path)
        self.bgcolor = np.asarray(bgcolor, np.float32)
        self.img_size = img_size
        self.pose_infos = self._load_mdm(pose_path)
        W, H = img_size
        self.K = np.array(
            [[focal, 0, W / 2.0], [0, focal, H / 2.0], [0, 0, 1]], np.float32
        )
        self.radius = radius

    @staticmethod
    def _load_mdm(path):
        data = dict(np.load(path, allow_pickle=True).item())
        thetas = np.asarray(data["thetas_ori"])  # (24, 3, T)
        poses = np.transpose(thetas, (2, 0, 1)).copy()  # (T, 24, 3)
        Rh = poses[:, 0].copy()
        Th = np.transpose(np.asarray(data["root_translation"]), (1, 0))  # (T, 3)
        poses[:, 0] = 0.0
        return {"poses": poses.reshape(len(poses), -1), "Rh": Rh, "Th": Th}

    def __len__(self):
        return len(self.pose_infos["poses"])

    def _camera_E(self):
        E = np.eye(4, dtype=np.float32)
        E[2, 3] = self.radius
        return E

    def __getitem__(self, idx):
        poses = self.pose_infos["poses"][idx].astype(np.float32)
        Rh = self.pose_infos["Rh"][idx].astype(np.float32)
        Th = self.pose_infos["Th"][0].astype(np.float32)
        E = apply_global_tfm_to_camera(
            self._camera_E(), Rh, Th - self.canonical_joints[0]
        )
        W, H = self.img_size
        out = {
            "frame_name": f"pose_{idx:06d}",
            "bgcolor": self.bgcolor / 255.0,
            "K": self.K.copy(),
            "E": E.astype(np.float32),
            "target_rgbs": np.zeros((H, W, 3), np.float32),
            "target_masks": np.zeros((H, W), np.float32),
        }
        out.update(self._skeleton_outputs(poses, self.canonical_joints))
        return out


# ---------------------------------------------------------------------------
# device transfer + prefetch
# ---------------------------------------------------------------------------

EXCLUDE_KEYS = ("frame_name", "img_width", "img_height")


def to_device(batch: dict, device="cuda") -> dict:
    """numpy item -> float32 tensors on ``device``, the non-array keys
    dropped.  For a CUDA device the copy goes through pinned memory without
    blocking, so that it queues behind the device's work instead of waiting
    for it; a ``CardArray`` already on it is handed over as it is."""
    device = torch.device(device)
    out = {}
    with span("data.to_device"):
        for k, v in batch.items():
            if k in EXCLUDE_KEYS:
                continue
            if isinstance(v, CardArray):
                out[k] = v.on(device)
                continue
            t = torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
            out[k] = t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t.to(device)
    return out


class _PrefetchError:
    """Sentinel carrying a worker exception to the consumer thread."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class Prefetcher:
    """Multi-worker background item loader: overlaps host decode with the
    device's step.

    ``workers`` threads decode items concurrently (cv2, PIL and libpng
    release the GIL) and the consumer receives them IN ORDER.  ``depth``
    bounds the number of decoded but unconsumed items (backpressure).  A
    worker's exception is re-raised in the consumer from ``__iter__``; a
    consumer that stops early releases the workers.

    The items' random draws come from the dataset's own stream, in the
    order the workers happen to take them; with a ``seed`` (a tuple of
    ints) the item at position ``pos`` draws from
    ``np.random.default_rng((*seed, pos))`` (``dataset.item``), so they do
    not depend on which worker takes which item.

    Spans and counters (``utils.profiling``), each with the item's position
    as its id: ``data.decode`` (a worker's ``dataset.item``),
    ``data.backpressure`` (a worker held by ``depth``),
    ``data.prefetch_wait`` (the consumer's wait for the next item, of zero
    length when it is ready), ``data.prefetch_take`` and
    ``data.prefetch_miss`` (a take that had to wait)."""

    def __init__(self, dataset, order=None, depth: int | None = None, workers: int | None = None,
                 seed: tuple | None = None):
        self.dataset = dataset
        self.seed = seed
        self.order = list(order) if order is not None else list(range(len(dataset)))
        if workers is None:
            # decode threads pay off only with real cores (on one core they
            # contend for the GIL); at most 4
            workers = min(4, os.cpu_count() or 1)
        self.workers = max(1, min(workers, len(self.order) or 1))
        self.depth = depth if depth is not None else 2 * self.workers
        self._idx_q: queue.Queue = queue.Queue()
        for pos, i in enumerate(self.order):
            self._idx_q.put((pos, i))
        self._results: dict[int, object] = {}
        self._cv = threading.Condition()
        self._next = 0  # next position the consumer will take
        self._closed = False  # consumer gone (early break): workers drain out
        self._threads = [
            threading.Thread(target=self._work, daemon=True)
            for _ in range(self.workers)
        ]
        for t in self._threads:
            t.start()

    def _blocked(self, pos: int, item) -> bool:
        """Backpressure: a decoded item may not run more than ``depth``
        ahead of the consumer."""
        return pos - self._next >= self.depth and not isinstance(item, _PrefetchError) and not self._closed

    def _work(self):
        while True:
            try:
                pos, i = self._idx_q.get_nowait()
            except queue.Empty:
                return
            try:
                with span("data.decode", pos, workers=self.workers):
                    if self.seed is None:
                        item = self.dataset[i]
                    else:
                        item = self.dataset.item(i, np.random.default_rng((*self.seed, pos)))
            except BaseException as exc:  # noqa: BLE001 - forwarded to consumer
                item = _PrefetchError(exc)
            with self._cv:
                if self._blocked(pos, item):
                    with span("data.backpressure", pos):
                        while self._blocked(pos, item):
                            self._cv.wait()
                if self._closed:
                    return
                self._results[pos] = item
                self._cv.notify_all()

    def __iter__(self):
        try:
            for pos in range(len(self.order)):
                with span("data.prefetch_wait", pos), self._cv:
                    missed = pos not in self._results
                    while pos not in self._results:
                        self._cv.wait()
                    item = self._results.pop(pos)
                    self._next = pos + 1
                    self._cv.notify_all()
                count("data.prefetch_take")
                if missed:
                    count("data.prefetch_miss")
                if isinstance(item, _PrefetchError):
                    raise RuntimeError("Prefetcher worker failed") from item.exc
                yield item
        finally:
            # consumer done or broke out early: release any workers blocked
            # in the backpressure wait so threads don't leak per epoch
            with self._cv:
                self._closed = True
                self._cv.notify_all()
