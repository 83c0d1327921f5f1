"""The SMPL body model in numpy and a procedural stand-in (port of
gomavatar_tpu/models/smpl.py).

``SMPL`` loads a standard SMPL v1.0 pkl and runs its LBS forward; the data
preparation scripts use it offline.  The licensed asset is not shipped, so
``synthetic_body``, a tube body with a 24-joint chain and distance-softmax
skinning, stands in for it.  The trained avatar
(``artifacts/e2e_trained.npz``) was trained on that mesh, so it must stay
bit-for-bit the reference's.
"""

from __future__ import annotations

import pickle

import numpy as np

from gomavatar_tpu_torch.ops.skeleton import SMPL_PARENT


class SMPL:
    """SMPL v1.0 pkl loader and full LBS forward (numpy, float64): shape
    and pose blendshapes, the kinematic chain, skinning."""

    def __init__(self, pkl_path: str):
        with open(pkl_path, "rb") as f:
            data = pickle.load(f, encoding="latin1")
        self.v_template = np.asarray(data["v_template"], np.float64)  # (N, 3)
        self.shapedirs = np.asarray(data["shapedirs"], np.float64)  # (N, 3, 10)
        self.posedirs = np.asarray(data["posedirs"], np.float64)  # (N, 3, 207)
        jr = data["J_regressor"]
        self.J_regressor = np.asarray(jr.todense() if hasattr(jr, "todense") else jr, np.float64)  # (24, N)
        self.weights = np.asarray(data["weights"], np.float64)  # (N, 24)
        self.faces = np.asarray(data["f"], np.int64)  # (F, 3)
        self.parent = SMPL_PARENT

    @staticmethod
    def _rodrigues(r):
        theta = np.linalg.norm(r)
        if theta < 1e-12:
            return np.eye(3)
        k = r / theta
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)

    def __call__(self, pose: np.ndarray, beta: np.ndarray, return_weights: bool = False):
        """pose (72,), beta (10,) -> (verts (N, 3), joints (24, 3)[, weights])."""
        pose = np.asarray(pose, np.float64).reshape(-1, 3)
        beta = np.asarray(beta, np.float64)
        v_shaped = self.v_template + self.shapedirs @ beta
        J = self.J_regressor @ v_shaped  # (24, 3)

        Rs = np.stack([self._rodrigues(pose[i]) for i in range(pose.shape[0])])
        # pose blendshapes from the non-root rotations
        pose_feature = (Rs[1:] - np.eye(3)).reshape(-1)  # (207,)
        v_posed = v_shaped + self.posedirs @ pose_feature

        G = np.zeros((24, 4, 4))
        G[0, :3, :3] = Rs[0]
        G[0, :3, 3] = J[0]
        G[0, 3, 3] = 1.0
        for i in range(1, 24):
            L = np.eye(4)
            L[:3, :3] = Rs[i]
            L[:3, 3] = J[i] - J[self.parent[i]]
            G[i] = G[self.parent[i]] @ L
        joints = G[:, :3, 3].copy()
        # remove the rest-pose joint offsets (SMPL's "A" subtraction)
        for i in range(24):
            G[i, :3, 3] -= G[i, :3, :3] @ J[i]

        T = np.einsum("nj,jab->nab", self.weights, G)
        v_h = np.concatenate([v_posed, np.ones((len(v_posed), 1))], axis=1)
        verts = np.einsum("nab,nb->na", T, v_h)[:, :3]
        if return_weights:
            return verts, joints, self.weights
        return verts, joints


def synthetic_body(
    n_rings: int = 32,
    n_seg: int = 24,
    height: float = 1.7,
    radius: float = 0.15,
    seed: int = 0,
):
    """Procedural tube-body mesh + 24-joint chain + skinning weights, as a
    ``canonical_info`` dict (canonical_vertex, canonical_lbs_weights,
    canonical_joints, faces, edges, canonical_bbox)."""
    rng = np.random.default_rng(seed)
    ys = np.linspace(-height / 2, height / 2, n_rings)
    angles = np.linspace(0, 2 * np.pi, n_seg, endpoint=False)
    # body profile: wider torso, narrower ends
    prof = radius * (0.6 + 0.4 * np.sin(np.linspace(0.15, np.pi - 0.15, n_rings)))
    verts = []
    for r_i, y in enumerate(ys):
        for a in angles:
            verts.append([prof[r_i] * np.cos(a), y, prof[r_i] * np.sin(a)])
    verts = np.asarray(verts, np.float64)

    faces = []
    for r in range(n_rings - 1):
        for s in range(n_seg):
            a = r * n_seg + s
            b = r * n_seg + (s + 1) % n_seg
            c = (r + 1) * n_seg + s
            d = (r + 1) * n_seg + (s + 1) % n_seg
            faces.append([a, b, c])
            faces.append([b, d, c])

    # Rounded multi-ring caps before the pole fan: a single ring-to-pole fan
    # makes sliver triangles whose Steiner ellipse covers dozens of tiles.
    CAP_RINGS = 3
    verts_list = [verts]
    n_base = len(verts)

    def _add_cap(end_ring_start, y_end, r_end, direction):
        nonlocal n_base
        prev = [end_ring_start + s for s in range(n_seg)]
        for k in range(1, CAP_RINGS + 1):
            frac = k / (CAP_RINGS + 1.0)
            rk = r_end * (1.0 - frac)
            yk = y_end + direction * 0.035 * np.sin(frac * np.pi / 2)
            ring = [[rk * np.cos(a), yk, rk * np.sin(a)] for a in angles]
            verts_list.append(np.asarray(ring))
            cur = [n_base + s for s in range(n_seg)]
            n_base += n_seg
            for s in range(n_seg):
                a0, b0 = prev[s], prev[(s + 1) % n_seg]
                c0, d0 = cur[s], cur[(s + 1) % n_seg]
                if direction > 0:
                    faces.append([a0, b0, c0])
                    faces.append([b0, d0, c0])
                else:
                    faces.append([b0, a0, c0])
                    faces.append([d0, b0, c0])
            prev = cur
        verts_list.append(np.asarray([[0.0, y_end + direction * 0.04, 0.0]]))
        pole = n_base
        n_base += 1
        for s in range(n_seg):
            if direction > 0:
                faces.append([prev[s], prev[(s + 1) % n_seg], pole])
            else:
                faces.append([prev[(s + 1) % n_seg], prev[s], pole])

    _add_cap((n_rings - 1) * n_seg, ys[-1], prof[-1], +1.0)
    _add_cap(0, ys[0], prof[0], -1.0)
    verts = np.vstack(verts_list)
    faces = np.asarray(faces, np.int64)

    # 24 joints along the body axis with small lateral offsets, root at the
    # pelvis
    joints = np.zeros((24, 3))
    joints[:, 1] = np.linspace(-height * 0.35, height * 0.45, 24)
    joints[:, 0] = rng.normal(scale=0.02, size=24)
    joints[0] = [0.0, -height * 0.1, 0.0]

    # skinning: softmax over negative squared distance to joints
    d2 = ((verts[:, None, :] - joints[None, :, :]) ** 2).sum(-1)
    w = np.exp(-d2 / (2 * 0.12**2))
    w = w / w.sum(axis=1, keepdims=True)

    return {
        "canonical_vertex": verts.astype(np.float32),
        "canonical_lbs_weights": w.astype(np.float32),
        "canonical_joints": joints.astype(np.float32),
        "faces": faces,
        "edges": None,
        "canonical_bbox": {
            "min_xyz": verts.min(0).astype(np.float32),
            "max_xyz": verts.max(0).astype(np.float32),
        },
    }


def synthetic_camera(img_size=(512, 512), distance: float = 3.0, focal: float = 550.0):
    """A simple front-facing camera looking at the origin: (K (3,3), E (4,4))."""
    W, H = img_size
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], np.float32)
    E = np.eye(4, dtype=np.float32)
    E[2, 3] = distance
    return K, E
