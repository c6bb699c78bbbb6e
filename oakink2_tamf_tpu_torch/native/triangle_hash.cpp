// Inside-mesh test: 2-D spatial triangle hash + z-ray parity query.
//
// Native (C++) replacement for the reference's Cython extension
// dev_fn/external/libmesh/triangle_hash.pyx + the MeshIntersector logic of
// inside_mesh.py:14-109, fused into one C call:
//   points are rescaled into [0.5, res-0.5]^3 grid coords, triangles hashed by
//   their 2-D (x,y) bbox cells, and each query point casts a +z ray counting
//   barycentric-contained crossings above AND below; inside = both parities
//   odd (the reference's contains1 & contains2).
//
// Exposed as a C ABI for ctypes; built with g++ at first use by
// oakink2_tamf_tpu_torch/native/__init__.py (copy of the JAX package's
// native/triangle_hash.cpp).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct Hash2D {
  int resolution;
  std::vector<std::vector<int>> cells;

  Hash2D(const double* tri2d, int n_tri, int res) : resolution(res), cells(res * res) {
    for (int t = 0; t < n_tri; ++t) {
      const double* a = tri2d + 6 * t;
      double minx = std::min({a[0], a[2], a[4]});
      double maxx = std::max({a[0], a[2], a[4]});
      double miny = std::min({a[1], a[3], a[5]});
      double maxy = std::max({a[1], a[3], a[5]});
      int x0 = std::clamp((int)minx, 0, res - 1);
      int x1 = std::clamp((int)maxx, 0, res - 1);
      int y0 = std::clamp((int)miny, 0, res - 1);
      int y1 = std::clamp((int)maxy, 0, res - 1);
      for (int x = x0; x <= x1; ++x)
        for (int y = y0; y <= y1; ++y) cells[res * x + y].push_back(t);
    }
  }
};

}  // namespace

extern "C" {

// verts: [n_verts, 3] float64, faces: [n_faces, 3] int32,
// points: [n_points, 3] float64, out: [n_points] uint8 (1 = inside).
void inside_mesh_query(const double* verts, int n_verts, const int32_t* faces,
                       int n_faces, const double* points, int n_points,
                       int resolution, uint8_t* out) {
  // gather triangles [n_faces, 3, 3]
  std::vector<double> tri(n_faces * 9);
  for (int f = 0; f < n_faces; ++f)
    for (int k = 0; k < 3; ++k) {
      const double* v = verts + 3 * faces[3 * f + k];
      tri[9 * f + 3 * k + 0] = v[0];
      tri[9 * f + 3 * k + 1] = v[1];
      tri[9 * f + 3 * k + 2] = v[2];
    }

  // bbox + rescale to [0.5, res-0.5]^3
  double bmin[3] = {1e300, 1e300, 1e300}, bmax[3] = {-1e300, -1e300, -1e300};
  for (int i = 0; i < n_faces * 3; ++i)
    for (int j = 0; j < 3; ++j) {
      bmin[j] = std::min(bmin[j], tri[3 * i + j]);
      bmax[j] = std::max(bmax[j], tri[3 * i + j]);
    }
  double scale[3], trans[3];
  for (int j = 0; j < 3; ++j) {
    double ext = bmax[j] - bmin[j];
    scale[j] = (resolution - 1) / (ext > 0 ? ext : 1.0);
    trans[j] = 0.5 - scale[j] * bmin[j];
  }
  for (int i = 0; i < n_faces * 3; ++i)
    for (int j = 0; j < 3; ++j) tri[3 * i + j] = scale[j] * tri[3 * i + j] + trans[j];

  // 2-D hash over (x, y)
  std::vector<double> tri2d(n_faces * 6);
  for (int f = 0; f < n_faces; ++f)
    for (int k = 0; k < 3; ++k) {
      tri2d[6 * f + 2 * k + 0] = tri[9 * f + 3 * k + 0];
      tri2d[6 * f + 2 * k + 1] = tri[9 * f + 3 * k + 1];
    }
  Hash2D hash(tri2d.data(), n_faces, resolution);

  for (int p = 0; p < n_points; ++p) {
    out[p] = 0;
    double q[3];
    bool in_aabb = true;
    for (int j = 0; j < 3; ++j) {
      q[j] = scale[j] * points[3 * p + j] + trans[j];
      if (q[j] < 0.0 || q[j] > resolution) in_aabb = false;
    }
    if (!in_aabb) continue;
    int cx = (int)q[0], cy = (int)q[1];
    if (cx < 0 || cx >= resolution || cy < 0 || cy >= resolution) continue;

    int above = 0, below = 0;
    for (int t : hash.cells[resolution * cx + cy]) {
      const double* a = &tri[9 * t];
      const double* b = &tri[9 * t + 3];
      const double* c = &tri[9 * t + 6];
      // 2-D barycentric containment (inside_mesh.py check_triangles)
      double A00 = a[0] - c[0], A01 = b[0] - c[0];
      double A10 = a[1] - c[1], A11 = b[1] - c[1];
      double y0 = q[0] - c[0], y1 = q[1] - c[1];
      double det = A00 * A11 - A01 * A10;
      if (det == 0.0) continue;
      double s = det > 0 ? 1.0 : -1.0;
      double ad = std::fabs(det);
      double u = (A11 * y0 - A01 * y1) * s;
      double v = (-A10 * y0 + A00 * y1) * s;
      double sum_uv = u + v;
      if (!(0 < u && u < ad && 0 < v && v < ad && 0 < sum_uv && sum_uv < ad)) continue;
      // intersection depth (inside_mesh.py compute_intersection_depth)
      double v1x = c[0] - a[0], v1y = c[1] - a[1], v1z = c[2] - a[2];
      double v2x = b[0] - a[0], v2y = b[1] - a[1], v2z = b[2] - a[2];
      double nx = v1y * v2z - v1z * v2y;
      double ny = v1z * v2x - v1x * v2z;
      double nz = v1x * v2y - v1y * v2x;
      double alpha = nx * (a[0] - q[0]) + ny * (a[1] - q[1]);
      double abs_nz = std::fabs(nz);
      if (abs_nz == 0.0) continue;
      double s_nz = nz > 0 ? 1.0 : -1.0;
      double depth = a[2] * abs_nz + alpha * s_nz;  // z_hit * |n_z|
      if (depth >= q[2] * abs_nz)
        ++above;
      else
        ++below;
    }
    out[p] = (above % 2 == 1) && (below % 2 == 1);
  }
}
}
