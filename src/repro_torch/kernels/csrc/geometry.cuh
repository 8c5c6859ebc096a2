// Exact-geometry predicates for the fused refine kernel, in two forms: the
// scalar ones (one thread a pair) and, at the end, the warp_* ones (one warp
// a pair), which the kernel takes for wide rings.
//
// Each function decides one (query window, stored geometry) pair by walking
// the geometry's nv vertices once. They are the per-record form of the
// batched predicates in repro_torch/core/geometry.py (the *_torch functions),
// with the same arithmetic term for term: every product and sum rounds on its
// own (the library is built with --fmad=false, so nothing is contracted into
// a fused multiply-add), divisions are IEEE, and min/max/compare follow the
// batched code. The batched code gathers each ring at a power-of-two width
// padded with the last vertex and masks the padding; every predicate is
// independent of that width, so a loop over exactly nv vertices decides the
// same.
#pragma once

namespace glin {

// Device predicate codes: geometry.PRED_* on the Python side.
enum : int {
  PRED_INTERSECTS = 0,
  PRED_CONTAINS = 1,   // proper (GEOS-style) contains
  PRED_COVERS = 2,
  PRED_WITHIN = 3,     // the geometry covers the window
  PRED_TOUCHES = 4,
  PRED_CROSSES = 5,
  PRED_DWITHIN = 6,
  PRED_COUNT = 7,
};

constexpr int kPolygon = 0;   // GeomKind.POLYGON: closed simple ring
constexpr int kPolyline = 1;  // GeomKind.POLYLINE: open chain

struct Rect {
  float x0, y0, x1, y1;  // [xmin, ymin, xmax, ymax]
};

// One record's ring inside the flat (pool_rows, 2) vertex pod pool.
struct Ring {
  const float* pool;
  int off, nv, kind, pool_rows;

  __device__ int row(int i) const {
    int j = off + i;
    return j < 0 ? 0 : (j > pool_rows - 1 ? pool_rows - 1 : j);
  }
  __device__ float x(int i) const { return pool[2 * row(i)]; }
  __device__ float y(int i) const { return pool[2 * row(i) + 1]; }
  // successor on the closed ring (polygon edges; also the ray cast's edges)
  __device__ int ring_next(int i) const { return i + 1 >= nv ? 0 : i + 1; }
  // kind-aware successor: closed ring for polygons, clamped open chain for
  // polylines (the last vertex pairs with itself: a zero-length segment)
  __device__ int seg_next(int i) const {
    return kind == kPolygon ? ring_next(i) : (i + 1 < nv - 1 ? i + 1 : nv - 1);
  }
};

__device__ inline bool strict_inside(const Rect& r, float px, float py) {
  return px > r.x0 && px < r.x1 && py > r.y0 && py < r.y1;
}

__device__ inline bool closed_inside(const Rect& r, float px, float py) {
  return px >= r.x0 && px <= r.x1 && py >= r.y0 && py <= r.y1;
}

// Liang–Barsky clip of P + t*D, t in [0, 1], against the closed window.
__device__ inline void clip_segment(const Rect& r, float x, float y, float dx,
                                    float dy, float& t0, float& t1,
                                    bool& reject) {
  const float eps = 1e-30f;
  const float ps[4] = {-dx, dx, -dy, dy};
  const float qs[4] = {x - r.x0, r.x1 - x, y - r.y0, r.y1 - y};
  t0 = 0.0f;
  t1 = 1.0f;
  reject = false;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float p = ps[k], q = qs[k];
    const float p_safe = p == 0.0f ? eps : p;
    const float rr = q / p_safe;
    if (p < 0.0f) t0 = fmaxf(t0, rr);
    if (p > 0.0f) t1 = fminf(t1, rr);
    reject = reject || (p == 0.0f && q < 0.0f);
  }
}

// Segment (x, y)-(x2, y2): meets the closed window (hit), and meets its open
// interior (open: the clipped span's midpoint is strictly inside).
__device__ inline void seg_hit_open(const Rect& r, float x, float y, float x2,
                                    float y2, bool& hit, bool& open) {
  const float dx = x2 - x, dy = y2 - y;
  float t0, t1;
  bool rej;
  clip_segment(r, x, y, dx, dy, t0, t1, rej);
  hit = t0 <= t1 && !rej;
  const float tm = (t0 + t1) * 0.5f;
  const float mx = x + tm * dx;
  const float my = y + tm * dy;
  open = hit && strict_inside(r, mx, my);
}

// Even-odd ray cast of one point over the closed ring -> (odd, on_edge).
__device__ inline void ray_cast(const Ring& g, float px, float py, bool& odd,
                                bool& on_edge) {
  int crossings = 0;
  on_edge = false;
  for (int i = 0; i < g.nv; ++i) {
    const int j = g.ring_next(i);
    const float x1 = g.x(i), y1 = g.y(i), x2 = g.x(j), y2 = g.y(j);
    const bool straddle = (y1 > py) != (y2 > py);
    const float denom = y2 - y1;
    const float denom_safe = denom == 0.0f ? 1.0f : denom;
    const float xint = x1 + (py - y1) / denom_safe * (x2 - x1);
    if (straddle && px < xint) ++crossings;
    const float cross = (x2 - x1) * (py - y1) - (y2 - y1) * (px - x1);
    const bool in_box = px >= fminf(x1, x2) && px <= fmaxf(x1, x2) &&
                        py >= fminf(y1, y2) && py <= fmaxf(y1, y2);
    if (cross == 0.0f && in_box) on_edge = true;
  }
  odd = (crossings % 2) == 1;
}

// The window's four corners then its centre (geometry._rect_corners order).
__device__ inline void rect_point(const Rect& r, int k, float& px, float& py) {
  switch (k) {
    case 0: px = r.x0; py = r.y0; break;
    case 1: px = r.x1; py = r.y0; break;
    case 2: px = r.x1; py = r.y1; break;
    case 3: px = r.x0; py = r.y1; break;
    default:
      px = (r.x0 + r.x1) * 0.5f;
      py = (r.y0 + r.y1) * 0.5f;
  }
}

// rect_covers_geoms: every vertex lies in the closed window.
__device__ inline bool covers(const Rect& r, const Ring& g) {
  for (int i = 0; i < g.nv; ++i)
    if (!closed_inside(r, g.x(i), g.y(i))) return false;
  return true;
}

// rect_contains_geoms_proper: covered, with an interior witness (a vertex,
// an edge midpoint, or for polygons the vertex mean strictly inside).
__device__ inline bool contains_proper(const Rect& r, const Ring& g) {
  if (!covers(r, g)) return false;
  bool wit = false;
  float sx = 0.0f, sy = 0.0f;
  for (int i = 0; i < g.nv; ++i) {
    const float x = g.x(i), y = g.y(i);
    const int j = g.seg_next(i);
    const float mx = (x + g.x(j)) * 0.5f;
    const float my = (y + g.y(j)) * 0.5f;
    wit = wit || strict_inside(r, x, y) || strict_inside(r, mx, my);
    sx = sx + x;
    sy = sy + y;
  }
  const float cnt = static_cast<float>(g.nv > 1 ? g.nv : 1);
  const float cx = sx / cnt, cy = sy / cnt;
  return wit || (g.kind == kPolygon && strict_inside(r, cx, cy));
}

// geoms_cover_rect: the polygon covers the whole window.
__device__ inline bool within(const Rect& r, const Ring& g) {
  if (g.kind != kPolygon) return false;
  for (int i = 0; i < g.nv; ++i) {
    const int j = g.ring_next(i);
    bool hit, open;
    seg_hit_open(r, g.x(i), g.y(i), g.x(j), g.y(j), hit, open);
    if (open) return false;
  }
  for (int k = 0; k < 5; ++k) {
    float px, py;
    bool odd, on;
    rect_point(r, k, px, py);
    ray_cast(g, px, py, odd, on);
    if (!(odd || on)) return false;
  }
  return true;
}

__device__ inline bool intersects(const Rect& r, const Ring& g) {
  if (g.kind == kPolygon) {
    for (int i = 0; i < g.nv; ++i) {
      const int j = g.ring_next(i);
      bool hit, open;
      seg_hit_open(r, g.x(i), g.y(i), g.x(j), g.y(j), hit, open);
      if (hit) return true;
    }
    for (int k = 0; k < 4; ++k) {
      float px, py;
      bool odd, on;
      rect_point(r, k, px, py);
      ray_cast(g, px, py, odd, on);
      if (odd || on) return true;
    }
    return false;
  }
  for (int i = 0; i < g.nv; ++i) {
    const float x = g.x(i), y = g.y(i);
    if (closed_inside(r, x, y)) return true;
    if (i + 1 < g.nv) {
      float t0, t1;
      bool rej;
      clip_segment(r, x, y, g.x(i + 1) - x, g.y(i + 1) - y, t0, t1, rej);
      if (t0 <= t1 && !rej) return true;
    }
  }
  return false;
}

// rect_interior_intersects_geoms: the geometry's interior meets the open
// window (DE-9IM int(W) ∩ int(G)).
__device__ inline bool interior_intersects(const Rect& r, const Ring& g) {
  for (int i = 0; i < g.nv; ++i) {
    const int j = g.seg_next(i);
    bool hit, open;
    seg_hit_open(r, g.x(i), g.y(i), g.x(j), g.y(j), hit, open);
    if (open) return true;
  }
  if (g.kind != kPolygon) return false;
  float px, py;
  bool odd, on;
  rect_point(r, 4, px, py);
  ray_cast(g, px, py, odd, on);
  return odd && !on;
}

__device__ inline bool touches(const Rect& r, const Ring& g) {
  bool edge_hit = false, edge_open = false;
  for (int i = 0; i < g.nv; ++i) {
    const int j = g.seg_next(i);
    bool hit, open;
    seg_hit_open(r, g.x(i), g.y(i), g.x(j), g.y(j), hit, open);
    edge_hit = edge_hit || hit;
    edge_open = edge_open || open;
  }
  bool corner_in = false, center_strict = false;
  for (int k = 0; k < 5; ++k) {
    float px, py;
    bool odd, on;
    rect_point(r, k, px, py);
    ray_cast(g, px, py, odd, on);
    if (k < 4)
      corner_in = corner_in || odd || on;
    else
      center_strict = odd && !on;
  }
  const bool poly = g.kind == kPolygon;
  const bool inter = edge_hit || (corner_in && poly);
  const bool interior = edge_open || (center_strict && poly);
  return inter && !interior;
}

__device__ inline bool crosses(const Rect& r, const Ring& g) {
  return g.kind == kPolyline && interior_intersects(r, g) && !covers(r, g);
}

// rect_geom_sqdist: squared distance between the closed window and the
// geometry (0 where they intersect).
__device__ inline float sqdist(const Rect& r, const Ring& g) {
  if (intersects(r, g)) return 0.0f;
  float vd2 = 1e30f, sd2 = 1e30f;
  for (int i = 0; i < g.nv; ++i) {
    const float x = g.x(i), y = g.y(i);
    const float ddx = fmaxf(fmaxf(r.x0 - x, x - r.x1), 0.0f);
    const float ddy = fmaxf(fmaxf(r.y0 - y, y - r.y1), 0.0f);
    vd2 = fminf(vd2, ddx * ddx + ddy * ddy);
    const int j = g.seg_next(i);
    const float ex = g.x(j) - x, ey = g.y(j) - y;
    const float ll = ex * ex + ey * ey;
    const float ll_safe = ll == 0.0f ? 1.0f : ll;
    for (int k = 0; k < 4; ++k) {
      float cx, cy;
      rect_point(r, k, cx, cy);
      const float px = cx - x, py = cy - y;
      float t = (px * ex + py * ey) / ll_safe;
      t = fminf(fmaxf(t, 0.0f), 1.0f);
      const float qx = px - t * ex;
      const float qy = py - t * ey;
      sd2 = fminf(sd2, qx * qx + qy * qy);
    }
  }
  return fminf(vd2, sd2);
}

__device__ inline bool eval_predicate(int code, const Rect& r, const Ring& g,
                                      float dist2) {
  switch (code) {
    case PRED_INTERSECTS: return intersects(r, g);
    case PRED_CONTAINS: return contains_proper(r, g);
    case PRED_COVERS: return covers(r, g);
    case PRED_WITHIN: return within(r, g);
    case PRED_TOUCHES: return touches(r, g);
    case PRED_CROSSES: return crosses(r, g);
    case PRED_DWITHIN: return sqdist(r, g) <= dist2;
    default: return false;
  }
}

// ------------------------------------------------ warp-cooperative forms
// The 32 lanes of a warp decide one (window, ring) pair together: lane i
// walks vertices i, i + 32, ..., and the votes, counts and minima combine
// across the warp. Every lane must call with the same ring (control flow is
// warp-uniform). Booleans combine by any/all and crossing counts by an
// integer sum, so they equal the scalar loop's; the sqdist minima are
// fminf over finite values, in any order the same; the vertex mean of
// contains_proper is summed left to right by lane 0, as the scalar loop does.
constexpr unsigned kFullMask = 0xffffffffu;

__device__ inline int warp_lane() { return threadIdx.x & 31; }

__device__ inline void warp_ray_cast(const Ring& g, float px, float py, bool& odd,
                                bool& on_edge) {
  int crossings = 0;
  bool on = false;
  for (int i = warp_lane(); i < g.nv; i += 32) {
    const int j = g.ring_next(i);
    const float x1 = g.x(i), y1 = g.y(i), x2 = g.x(j), y2 = g.y(j);
    const bool straddle = (y1 > py) != (y2 > py);
    const float denom = y2 - y1;
    const float denom_safe = denom == 0.0f ? 1.0f : denom;
    const float xint = x1 + (py - y1) / denom_safe * (x2 - x1);
    if (straddle && px < xint) ++crossings;
    const float cross = (x2 - x1) * (py - y1) - (y2 - y1) * (px - x1);
    const bool in_box = px >= fminf(x1, x2) && px <= fmaxf(x1, x2) &&
                        py >= fminf(y1, y2) && py <= fmaxf(y1, y2);
    if (cross == 0.0f && in_box) on = true;
  }
  odd = (__reduce_add_sync(kFullMask, crossings) % 2) == 1;
  on_edge = __any_sync(kFullMask, on);
}

__device__ inline bool warp_covers(const Rect& r, const Ring& g) {
  bool out = false;
  for (int i = warp_lane(); i < g.nv; i += 32) out = out || !closed_inside(r, g.x(i), g.y(i));
  return !__any_sync(kFullMask, out);
}

__device__ inline bool warp_contains_proper(const Rect& r, const Ring& g) {
  if (!warp_covers(r, g)) return false;
  bool wit = false;
  for (int i = warp_lane(); i < g.nv; i += 32) {
    const float x = g.x(i), y = g.y(i);
    const int j = g.seg_next(i);
    const float mx = (x + g.x(j)) * 0.5f;
    const float my = (y + g.y(j)) * 0.5f;
    wit = wit || strict_inside(r, x, y) || strict_inside(r, mx, my);
  }
  if (__any_sync(kFullMask, wit)) return true;
  if (g.kind != kPolygon) return false;
  bool in = false;
  if (warp_lane() == 0) {
    float sx = 0.0f, sy = 0.0f;
    for (int i = 0; i < g.nv; ++i) {
      sx = sx + g.x(i);
      sy = sy + g.y(i);
    }
    const float cnt = static_cast<float>(g.nv > 1 ? g.nv : 1);
    in = strict_inside(r, sx / cnt, sy / cnt);
  }
  return __shfl_sync(kFullMask, static_cast<int>(in), 0) != 0;
}

// any polygon edge (closed ring) or kind-aware segment: hit / open votes
__device__ inline void warp_edge_votes(const Rect& r, const Ring& g, bool ring,
                                  bool& hit_any, bool& open_any) {
  bool h = false, o = false;
  for (int i = warp_lane(); i < g.nv; i += 32) {
    const int j = ring ? g.ring_next(i) : g.seg_next(i);
    bool hit, open;
    seg_hit_open(r, g.x(i), g.y(i), g.x(j), g.y(j), hit, open);
    h = h || hit;
    o = o || open;
  }
  hit_any = __any_sync(kFullMask, h);
  open_any = __any_sync(kFullMask, o);
}

__device__ inline bool warp_within(const Rect& r, const Ring& g) {
  if (g.kind != kPolygon) return false;
  bool hit, open;
  warp_edge_votes(r, g, true, hit, open);
  if (open) return false;
  for (int k = 0; k < 5; ++k) {
    float px, py;
    bool odd, on;
    rect_point(r, k, px, py);
    warp_ray_cast(g, px, py, odd, on);
    if (!(odd || on)) return false;
  }
  return true;
}

__device__ inline bool warp_intersects(const Rect& r, const Ring& g) {
  if (g.kind == kPolygon) {
    bool hit, open;
    warp_edge_votes(r, g, true, hit, open);
    if (hit) return true;
    for (int k = 0; k < 4; ++k) {
      float px, py;
      bool odd, on;
      rect_point(r, k, px, py);
      warp_ray_cast(g, px, py, odd, on);
      if (odd || on) return true;
    }
    return false;
  }
  bool any = false;
  for (int i = warp_lane(); i < g.nv; i += 32) {
    const float x = g.x(i), y = g.y(i);
    bool h = closed_inside(r, x, y);
    if (i + 1 < g.nv) {
      float t0, t1;
      bool rej;
      clip_segment(r, x, y, g.x(i + 1) - x, g.y(i + 1) - y, t0, t1, rej);
      h = h || (t0 <= t1 && !rej);
    }
    any = any || h;
  }
  return __any_sync(kFullMask, any);
}

__device__ inline bool warp_interior_intersects(const Rect& r, const Ring& g) {
  bool hit, open;
  warp_edge_votes(r, g, false, hit, open);
  if (open) return true;
  if (g.kind != kPolygon) return false;
  float px, py;
  bool odd, on;
  rect_point(r, 4, px, py);
  warp_ray_cast(g, px, py, odd, on);
  return odd && !on;
}

__device__ inline bool warp_touches(const Rect& r, const Ring& g) {
  bool edge_hit, edge_open;
  warp_edge_votes(r, g, false, edge_hit, edge_open);
  bool corner_in = false, center_strict = false;
  for (int k = 0; k < 5; ++k) {
    float px, py;
    bool odd, on;
    rect_point(r, k, px, py);
    warp_ray_cast(g, px, py, odd, on);
    if (k < 4)
      corner_in = corner_in || odd || on;
    else
      center_strict = odd && !on;
  }
  const bool poly = g.kind == kPolygon;
  const bool inter = edge_hit || (corner_in && poly);
  const bool interior = edge_open || (center_strict && poly);
  return inter && !interior;
}

__device__ inline bool warp_crosses(const Rect& r, const Ring& g) {
  return g.kind == kPolyline && warp_interior_intersects(r, g) && !warp_covers(r, g);
}

__device__ inline float warp_sqdist(const Rect& r, const Ring& g) {
  if (warp_intersects(r, g)) return 0.0f;
  float vd2 = 1e30f, sd2 = 1e30f;
  for (int i = warp_lane(); i < g.nv; i += 32) {
    const float x = g.x(i), y = g.y(i);
    const float ddx = fmaxf(fmaxf(r.x0 - x, x - r.x1), 0.0f);
    const float ddy = fmaxf(fmaxf(r.y0 - y, y - r.y1), 0.0f);
    vd2 = fminf(vd2, ddx * ddx + ddy * ddy);
    const int j = g.seg_next(i);
    const float ex = g.x(j) - x, ey = g.y(j) - y;
    const float ll = ex * ex + ey * ey;
    const float ll_safe = ll == 0.0f ? 1.0f : ll;
    for (int k = 0; k < 4; ++k) {
      float cx, cy;
      rect_point(r, k, cx, cy);
      const float px = cx - x, py = cy - y;
      float t = (px * ex + py * ey) / ll_safe;
      t = fminf(fmaxf(t, 0.0f), 1.0f);
      const float qx = px - t * ex;
      const float qy = py - t * ey;
      sd2 = fminf(sd2, qx * qx + qy * qy);
    }
  }
  float d = fminf(vd2, sd2);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) d = fminf(d, __shfl_xor_sync(kFullMask, d, o));
  return d;
}

__device__ inline bool warp_eval_predicate(int code, const Rect& r, const Ring& g,
                                      float dist2) {
  switch (code) {
    case PRED_INTERSECTS: return warp_intersects(r, g);
    case PRED_CONTAINS: return warp_contains_proper(r, g);
    case PRED_COVERS: return warp_covers(r, g);
    case PRED_WITHIN: return warp_within(r, g);
    case PRED_TOUCHES: return warp_touches(r, g);
    case PRED_CROSSES: return warp_crosses(r, g);
    case PRED_DWITHIN: return warp_sqdist(r, g) <= dist2;
    default: return false;
  }
}

}  // namespace glin
